"""The batch layout the model consumes (the training step comes later)."""
