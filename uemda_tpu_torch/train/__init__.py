"""Training: learning-rate schedule, optimizer, train state, stage steps
and the step loop."""
