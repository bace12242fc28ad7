"""Training pieces of the port: the optimizers, clipping and LR schedules
(``optimizer``), the LM zoo's step builders and train state
(``trainstep``) and checkpoints (``checkpoint``)."""
from repro_torch.train.checkpoint import (atomic_write_json, latest_step,
                                          load_metadata, restore_checkpoint,
                                          restore_latest, save_checkpoint,
                                          valid_steps)
from repro_torch.train.optimizer import (Optimizer, adamw, apply_updates,
                                         clip_by_global_norm, constant_lr,
                                         cosine_lr, global_norm, sgd,
                                         warmup_cosine_lr)
from repro_torch.train.trainstep import (TrainState, init_train_state,
                                         make_eval_step, make_prefill_step,
                                         make_serve_step, make_train_step)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_latest",
           "latest_step", "valid_steps", "load_metadata",
           "atomic_write_json", "Optimizer", "sgd", "adamw",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "constant_lr", "cosine_lr", "warmup_cosine_lr", "TrainState",
           "init_train_state", "make_train_step", "make_eval_step",
           "make_prefill_step", "make_serve_step"]
