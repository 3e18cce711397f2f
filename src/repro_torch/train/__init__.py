"""Training: optimizers, FP-delta checkpoints and the host training loop."""
