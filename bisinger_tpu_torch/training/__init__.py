"""Training of the two acoustic stages: losses, optimizer, checkpoints, tasks, trainer."""
