"""Parallel training of the PyTorch port: only `resilience.
retry_transient` so far (the JAX package's sharding, ZeRO and elastic
layers are not ported)."""
