"""Command-line tools of the port (python -m gencast_tpu_torch.tools.<name>)."""
