"""Stage-1 losses (counterpart of `scenedino_tpu.losses`)."""
