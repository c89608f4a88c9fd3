"""mx.optimizer namespace of the PyTorch port."""
from .optimizer import (Optimizer, SGD, Adam, register, create,
                        get_updater, Updater)

__all__ = ["Optimizer", "SGD", "Adam", "register", "create", "get_updater",
           "Updater"]
