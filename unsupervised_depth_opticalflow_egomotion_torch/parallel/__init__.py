from .batch import to_device_batch
from .mesh import distributed_init
from .train_step import build_model, init_state, make_optimizer, make_train_step

__all__ = ["build_model", "distributed_init", "init_state",
           "make_optimizer", "make_train_step", "to_device_batch"]
