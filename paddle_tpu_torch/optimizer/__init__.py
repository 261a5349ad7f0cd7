from . import lr  # noqa: F401
from .optimizer import Optimizer, opt_state_from_numpy  # noqa: F401
from .optimizers import (  # noqa: F401
    SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Lars, LarsMomentum,
    Momentum, RMSProp)
