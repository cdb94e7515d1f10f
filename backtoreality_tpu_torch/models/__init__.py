"""Detector models (PyTorch)."""
