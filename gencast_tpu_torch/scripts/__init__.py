"""Command-line scripts of the port (`python -m gencast_tpu_torch.scripts.<name>`)."""
