from .batch import to_device_batch
from .train_step import build_model, init_state, make_optimizer, make_train_step

__all__ = ["build_model", "init_state", "make_optimizer", "make_train_step", "to_device_batch"]
