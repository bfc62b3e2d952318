"""Tensor ops of the port; ``blobs_cuda`` and ``scan_cuda`` hold the kernels."""
