"""Training: optimizer and schedule, train state, the train step, metrics."""
