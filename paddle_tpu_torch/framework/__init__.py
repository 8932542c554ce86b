"""Framework services of the port: the checkpoint manifest protocol
(`checkpoint_manager`)."""
