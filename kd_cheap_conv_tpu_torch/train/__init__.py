"""Train, KD and eval steps, the optimizer, checkpoints, the training loop
and validate."""
