"""Kernels of the port: hand-written CUDA for Hopper beside plain versions.

``ops`` dispatches by device; ``diffusion`` (the FL data plane and the
device planner's bids, with the flatten/unflatten pair), ``stc_compress``
(the host plane's whole-tensor STC) and ``quant`` (the int8 hop wire) hold
the FL plane's CUDA wrappers, ``ref`` the plain PyTorch versions,
``launch`` the wrappers' checks and launch counters, ``build`` the ``nvcc``
+ ``ctypes`` loader.  No CUDA work happens at import time.
"""
from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
from repro_torch.kernels.quant import QUANT_BLOCK

__all__ = ["LAUNCHES", "reset_launch_counts", "QUANT_BLOCK"]
