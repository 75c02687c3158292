"""Writes: one object a request, compressed into one LZ4 frame by
``compress_frame_parallel`` and returned as bytes on the host.

Every kept frame has to equal, byte for byte, ``reference.frame`` of the
same object at the configuration's settings: the C library's greedy parse
of each block inside the lz4 CLI's header, end mark and content checksum.
"""

from __future__ import annotations

from lz4bench import reference

SIDE = "compress"


def prepare(objects: list[bytes], config: dict) -> list[bytes]:
    """The inputs, one a request: input k is object k."""
    return objects


def call(lt, data: bytes, config: dict, device, control: dict) -> bytes:
    level = config["level"]
    if level >= 3:
        raise ValueError("a write of level 3 or more is the HC parse, not this call")
    return lt.compress_frame_parallel(
        data,
        config["block_size"],
        device=device,
        content_checksum=config["content_checksum"],
        block_checksums=config["block_checksums"],
        with_content_size=config["content_size"],
        acceleration=1 - level if level < 0 else 1,
        parallel_linked=not config["independent_blocks"],
        **control,
    )


def sizes(data: bytes, frame: bytes) -> tuple[int, int]:
    """(bytes the request brings, bytes it returns)."""
    return len(data), len(frame)


def check(kept, objects, inputs, job) -> dict[str, tuple[int, int]]:
    """``kept`` is ``[(input index, frame)]``, input k object k; each
    number with its limit."""
    ks = sorted({k for k, _ in kept})
    want = dict(zip(ks, reference.frames([objects[k] for k in ks], job.config)))
    return {
        "wrong_frames": (sum(out != want[k] for k, out in kept), 0),
        "objects_unchecked": (len(inputs) - len(want), 0),
    }
