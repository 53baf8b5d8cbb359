"""Training: optimizer and schedule, train state, the train step, metrics,
checkpoints and the fit loop."""
