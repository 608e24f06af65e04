"""Host feed and synthetic frames."""
