"""Data parallelism of the port (counterpart of `scenedino_tpu/parallel/`)."""
