"""Fused ops of the port (paddle_tpu.incubate counterpart)."""
