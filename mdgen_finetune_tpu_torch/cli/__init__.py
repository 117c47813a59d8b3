"""Command-line entry points (``python -m mdgen_finetune_tpu_torch.cli.<name>``)."""
