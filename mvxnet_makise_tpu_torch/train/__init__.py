"""Training: batch layout, loss, optimizer, step, checkpoints, loop."""
