"""Command-line tools of the port (``python -m tlie_tpu_torch.tools.<name>``)."""
