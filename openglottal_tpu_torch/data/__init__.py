"""Synthetic test video."""
