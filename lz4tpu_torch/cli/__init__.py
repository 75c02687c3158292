"""Command-line tools: ``dolz4`` (compress a file into an LZ4 frame) and
``delz4`` (decompress one), run as ``python3 -m lz4tpu_torch.cli.dolz4``
and ``python3 -m lz4tpu_torch.cli.delz4``."""
