"""Fleet utilities of the port (paddle_tpu/distributed/fleet)."""
