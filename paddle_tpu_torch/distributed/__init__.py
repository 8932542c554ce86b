"""Distributed training utilities of the port (paddle_tpu/distributed):
so far only ``fleet.utils.recompute``."""
