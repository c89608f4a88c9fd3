"""mx.optimizer namespace of the PyTorch port."""
from .optimizer import (Optimizer, SGD, NAG, Adam, AdaGrad, AdaDelta,
                        RMSProp, Ftrl, Signum, SignSGD, LAMB, Adamax, Nadam,
                        SGLD, Test, register, create, get_updater, Updater)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "SignSGD", "LAMB", "Adamax",
           "Nadam", "SGLD", "Test", "register", "create", "get_updater",
           "Updater"]
