from .config import PORT_ONLY_FIELDS, Config, load_config, loss_weights

__all__ = ["PORT_ONLY_FIELDS", "Config", "load_config", "loss_weights"]
