"""Synthetic data, Dirichlet partitions and client loaders (numpy)."""
from repro_torch.data.partitioner import ClientPartition, dirichlet_partition
from repro_torch.data.pipeline import (ClientLoader, lm_batches,
                                       make_client_loaders)
from repro_torch.data.synthetic import (ImageDataset, class_labels_for_lm,
                                        gaussian_image_dataset, lm_corpus)

__all__ = ["ClientPartition", "dirichlet_partition", "ClientLoader",
           "make_client_loaders", "lm_batches", "ImageDataset", "gaussian_image_dataset",
           "lm_corpus", "class_labels_for_lm"]
