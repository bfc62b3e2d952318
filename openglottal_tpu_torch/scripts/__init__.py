"""Command-line entry points of the port (``python -m
openglottal_tpu_torch.scripts.<name>``, or through ``python -m
openglottal_tpu_torch.cli``)."""
