"""Distributed incubating models of the port (paddle_tpu.incubate.
distributed counterpart)."""
from . import models  # noqa: F401
