"""Framework services of the port: the checkpoint manifest protocol
(`checkpoint_manager`), the JAX key stream (`prng`) and CUDA graph capture
of one step (`capture`)."""
