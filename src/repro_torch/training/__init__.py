"""Training: the counterpart of ``repro.training`` (``make_compressed_train_step``
reduces the gradients across the pods of a device mesh in int8)."""
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import make_compressed_train_step, make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "make_compressed_train_step",
           "make_train_step"]
