"""Utilities of the port: the runtime flag registry (`flags`), fault
injection (`fault_injection`), the flat monitor counters (`monitor`)
and the framework logger (`log`)."""
