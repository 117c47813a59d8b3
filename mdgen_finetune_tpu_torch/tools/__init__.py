"""Measurement tools of the PyTorch port (``python -m mdgen_finetune_tpu_torch.tools.<name>``)."""
