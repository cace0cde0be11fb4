"""Runnable examples of the port (`python -m kmersgwas_tpu_torch.examples.<name>`)."""
