"""Training: optimizer, train state, EMA-carrying step functions, checkpoints."""
