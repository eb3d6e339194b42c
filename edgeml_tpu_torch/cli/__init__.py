"""Command-line entry points (``python -m edgeml_tpu_torch.cli.<name>``)."""
