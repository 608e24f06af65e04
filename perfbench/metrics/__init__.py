"""Per-layer metric readers: ``<metric>.py`` with ``read(ctx)``."""
