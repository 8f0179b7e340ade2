"""The stage-1 training step (counterpart of `scenedino_tpu.training`)."""
