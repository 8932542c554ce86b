"""Fleet utilities of the port (paddle_tpu/distributed/fleet)."""
from . import utils
from .utils import recompute

__all__ = ["recompute", "utils"]
