"""Command-line entry points of the port (see bm25_tpu_torch.cli.main)."""
