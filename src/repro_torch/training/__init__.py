"""Training on one device: the counterpart of ``repro.training``.
``make_compressed_train_step`` (int8 gradients across the pods of a mesh)
is not ported: it waits for the port's device mesh."""
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.training.train_step import make_train_step

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "make_train_step"]
