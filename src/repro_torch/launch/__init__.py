"""Command-line entry points of the port (``python -m
repro_torch.launch.sweep``, ``serve``, ``train`` and ``fl_spmd``)."""
