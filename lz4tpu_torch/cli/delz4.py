"""``delz4`` — file-to-file LZ4 frame decompression.

The port's counterpart of ``lz4tpu/cli/delz4.py`` (reference
``examples/delz4.rs``).  Engines: ``cuda`` (the default:
``decompress_frame`` on the card, an independent frame's blocks in one
launch), ``cpu`` (the same on the kernels' plain versions), ``native``
(the host's C++ decoder, an independent frame's blocks on a pool of
threads; no card needed), ``cuda-parallel`` and ``cpu-parallel``
(``decompress_frame_parallel``).

    python3 -m lz4tpu_torch.cli.delz4 in.lz4 out [--engine cuda] [-v]
"""

from __future__ import annotations

import argparse
import sys
import time

from .dolz4 import ENGINES, read_input, write_output


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="delz4", description="Decompress an LZ4 frame file.")
    p.add_argument("input", help="input .lz4 file ('-' for stdin)")
    p.add_argument("output", help="output file ('-' for stdout)")
    p.add_argument("--engine", default="cuda", choices=ENGINES,
                   help="cuda/cpu/native: the streaming reader; *-parallel: "
                        "decompress_frame_parallel")
    p.add_argument("--dictionary", help="preset dictionary file")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device, parallel = args.engine.removesuffix("-parallel"), args.engine.endswith("-parallel")
    frame = read_input(args.input)
    dictionary = read_input(args.dictionary) if args.dictionary else b""

    t0 = time.perf_counter()
    if parallel:
        from lz4tpu_torch import decompress_frame_parallel

        data = decompress_frame_parallel(frame, device=device, dictionary=dictionary)
    else:
        from lz4tpu_torch import decompress_frame

        data = decompress_frame(frame, dictionary=dictionary, engine=device)
    dt = time.perf_counter() - t0

    write_output(args.output, data)
    if args.verbose:
        print(f"{len(frame)} -> {len(data)} bytes in {dt:.3f}s = "
              f"{len(data) / dt / 1e6:.1f} MB/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
