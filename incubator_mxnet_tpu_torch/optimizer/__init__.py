"""mx.optimizer namespace of the PyTorch port."""
from .optimizer import (Optimizer, SGD, NAG, Adam, register, create,
                        get_updater, Updater)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "register", "create",
           "get_updater", "Updater"]
