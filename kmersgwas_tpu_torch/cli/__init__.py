"""Command-line entry points (`python -m kmersgwas_tpu_torch.cli <command>`),
mirroring kmersgwas_tpu.cli: all 17 of its commands, with `--device` on
those that touch the card (cli/__main__.py).
"""
