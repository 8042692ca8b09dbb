from .device import resolve_device
from .jax_weights import load_jax_variables

__all__ = ["resolve_device", "load_jax_variables"]
