"""Synthetic data, Dirichlet partitions and client loaders (numpy)."""
from repro_torch.data.partitioner import ClientPartition, dirichlet_partition
from repro_torch.data.pipeline import ClientLoader, make_client_loaders
from repro_torch.data.synthetic import ImageDataset, gaussian_image_dataset

__all__ = ["ClientPartition", "dirichlet_partition", "ClientLoader",
           "make_client_loaders", "ImageDataset", "gaussian_image_dataset"]
