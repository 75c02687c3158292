"""``dolz4`` — file-to-file LZ4 frame compression.

The port's counterpart of ``lz4tpu/cli/dolz4.py`` (reference
``examples/dolz4.rs``), flag for flag.  Engines: ``cuda`` (the default:
``CompressionSettings`` on the card, an independent frame's blocks in one
launch a batch), ``cpu`` (the same on the kernels' plain versions),
``native`` (the host's C++ codec, an independent frame's blocks on a pool
of threads; no card needed), ``cuda-parallel`` and ``cpu-parallel``
(``compress_frame_parallel``: the whole frame in one launch,
``--linked-blocks`` as ``parallel_linked``, ``--lane-kernel`` for the lane
compressor).

    python3 -m lz4tpu_torch.cli.dolz4 in out.lz4 [--engine cuda] [-v]
"""

from __future__ import annotations

import argparse
import sys
import time

ENGINES = ["cuda", "cpu", "native", "cuda-parallel", "cpu-parallel"]


def read_input(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def write_output(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
        return
    with open(path, "wb") as f:
        f.write(data)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dolz4", description="Compress a file into an LZ4 frame.")
    p.add_argument("input", help="input file ('-' for stdin)")
    p.add_argument("output", help="output file ('-' for stdout)")
    p.add_argument("--engine", default="cuda", choices=ENGINES,
                   help="cuda/cpu/native: the streaming writer; *-parallel: the whole frame in "
                        "one launch (compress_frame_parallel)")
    p.add_argument("--block-size", type=int, default=4 * 1024 * 1024,
                   help="64KiB/256KiB/1MiB/4MiB (bytes)")
    p.add_argument("--linked-blocks", action="store_true",
                   help="linked (dependent) blocks: better ratio, no seeking")
    p.add_argument("--block-checksums", action="store_true")
    p.add_argument("--no-content-checksum", action="store_true")
    p.add_argument("--no-content-size", action="store_true")
    p.add_argument("--acceleration", type=int, default=1)
    p.add_argument("--level", type=int, default=None,
                   help="high-compression level (2-12): hash-chain + lazy parse on the host")
    p.add_argument("--dictionary", help="preset dictionary file")
    p.add_argument("--dictionary-id", type=int, default=0)
    p.add_argument("--lane-kernel", action="store_true",
                   help="*-parallel only: the lane compressor (32 KiB chunks spliced into "
                        "blocks; valid LZ4, not byte-identical to the reference parse)")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device, parallel = args.engine.removesuffix("-parallel"), args.engine.endswith("-parallel")
    if parallel and args.level:
        raise SystemExit("--level is a host-parse feature; use engine cuda, cpu or native")
    if args.lane_kernel and not parallel:
        raise SystemExit("--lane-kernel needs engine cuda-parallel or cpu-parallel")
    data = read_input(args.input)
    dictionary = read_input(args.dictionary) if args.dictionary else None

    t0 = time.perf_counter()
    if parallel:
        from lz4tpu_torch import compress_frame_parallel

        frame = compress_frame_parallel(
            data,
            block_size=args.block_size,
            device=device,
            content_checksum=not args.no_content_checksum,
            block_checksums=args.block_checksums,
            with_content_size=not args.no_content_size,
            acceleration=args.acceleration,
            parallel_linked=args.linked_blocks,
            dictionary=dictionary,
            dictionary_id=args.dictionary_id if args.dictionary_id else None,
            lane_kernel=args.lane_kernel,
        )
    else:
        from lz4tpu_torch import CompressionSettings

        s = (
            CompressionSettings()
            .engine(device)
            .block_size(args.block_size)
            .independent_blocks(not args.linked_blocks)
            .block_checksums(args.block_checksums)
            .content_checksum(not args.no_content_checksum)
            .acceleration(args.acceleration)
            .level(args.level)
        )
        if dictionary is not None:
            s.dictionary(args.dictionary_id, dictionary)
        frame = s.compress_bytes(data, with_size=not args.no_content_size)
    dt = time.perf_counter() - t0

    write_output(args.output, frame)
    if args.verbose:
        ratio = len(frame) / max(len(data), 1)
        print(f"{len(data)} -> {len(frame)} bytes (ratio {ratio:.3f}) in {dt:.3f}s = "
              f"{len(data) / dt / 1e6:.1f} MB/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
