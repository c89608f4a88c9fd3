"""mx.optimizer namespace of the PyTorch port."""
from .optimizer import (Optimizer, Adam, register, create, get_updater,
                        Updater)

__all__ = ["Optimizer", "Adam", "register", "create", "get_updater",
           "Updater"]
