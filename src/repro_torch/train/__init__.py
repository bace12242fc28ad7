"""Local solver pieces of the port (SGD with momentum, clipping), the LM
zoo's step builders (``trainstep``) and checkpoints (``checkpoint``)."""
from repro_torch.train.checkpoint import (atomic_write_json, latest_step,
                                          load_metadata, restore_checkpoint,
                                          restore_latest, save_checkpoint,
                                          valid_steps)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step", "valid_steps", "load_metadata",
           "atomic_write_json"]
