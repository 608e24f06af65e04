"""Calibration matrices and box geometry."""
