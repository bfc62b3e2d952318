"""Synthetic test video and colour conversion."""
