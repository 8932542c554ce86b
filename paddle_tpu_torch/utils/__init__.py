"""Utilities of the port: the runtime flag registry (`flags`), fault
injection (`fault_injection`), the flat monitor counters (`monitor`)
and the framework logger (`log`)."""
from . import flags
from .flags import get_flags, set_flags

__all__ = ["flags", "get_flags", "set_flags"]
