"""Training: optimizers, gradient compression and the train step."""
