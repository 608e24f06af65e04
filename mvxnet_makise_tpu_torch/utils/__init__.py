"""Training observability."""
