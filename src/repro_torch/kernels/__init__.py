"""Kernels of the port: hand-written CUDA for Hopper beside plain versions.

``ops`` dispatches by device, ``diffusion`` holds the CUDA wrappers and the
flatten/unflatten pair, ``ref`` the plain PyTorch versions, ``build`` the
``nvcc`` + ``ctypes`` loader.  No CUDA work happens at import time.
"""
