"""Prediction decoding."""
