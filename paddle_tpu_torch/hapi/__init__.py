"""High-level training API (port of paddle_tpu/hapi): `Model` and the
callbacks."""
from . import callbacks  # noqa: F401
from .callbacks import (Callback, EarlyStopping,  # noqa: F401
                        LRScheduler, ModelCheckpoint, ProgBarLogger,
                        ReduceLROnPlateau)
from .model import Model  # noqa: F401
