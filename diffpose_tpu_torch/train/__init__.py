"""Training: optimizer, train state, train and eval step functions, checkpoints, the runner."""
