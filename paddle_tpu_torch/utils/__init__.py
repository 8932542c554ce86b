"""Utilities of the port: the runtime flag registry (`flags`)."""
