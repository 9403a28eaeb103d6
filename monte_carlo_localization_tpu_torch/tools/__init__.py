"""Command-line tools of the port (``python -m
monte_carlo_localization_tpu_torch.tools.<name>``)."""
