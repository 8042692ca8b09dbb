from .config import Config, load_config, loss_weights

__all__ = ["Config", "load_config", "loss_weights"]
