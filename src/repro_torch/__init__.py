"""PyTorch/CUDA port of the FedDif reproduction.

``repro_torch`` mirrors the layout and names of the JAX package ``repro``
module for module: ``repro_torch.data.partitioner`` is the counterpart of
``repro.data.partitioner``, and so on.  It imports ``torch``, ``numpy`` and
``scipy`` only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without that request they raise.  The
FL data plane's hot loops run as hand-written CUDA kernels for Hopper
(``repro_torch.kernels``), built with ``nvcc`` on first use.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
