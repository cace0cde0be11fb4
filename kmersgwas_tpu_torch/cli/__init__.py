"""Command-line entry points (`python -m kmersgwas_tpu_torch.cli <command>`),
mirroring kmersgwas_tpu.cli. Ported so far:

  reference binary                      | subcommand
  --------------------------------------+----------------------------
  associate_kmers                       | associate (adds --device)
"""
