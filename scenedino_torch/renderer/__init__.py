"""Volume rendering of the training step (counterpart of `scenedino_tpu.renderer`)."""
