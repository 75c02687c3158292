"""Reads: one stored frame a request, decompressed by
``decompress_frame_parallel`` (checksums verified) and returned as bytes
on the host.

The stored frames are the lz4 CLI's (the C library's frame API), made at set-up from the seed's
objects at the configuration's settings.  Every kept answer has to equal
its object.  The content checksum is held apart: frames with one byte of
content changed (``reference.corrupt``) go through the same call after the
window, and each has to be refused with the program's ``LZ4Error``.
"""

from __future__ import annotations

from lz4bench import reference

SIDE = "decompress"


def prepare(objects: list[bytes], config: dict) -> list[bytes]:
    """The inputs, one a request: input k is the stored frame of object k."""
    return reference.stored_frames(objects, config)


def call(lt, frame: bytes, config: dict, device, control: dict) -> bytes:
    return lt.decompress_frame_parallel(frame, device=device, **control)


def sizes(frame: bytes, content: bytes) -> tuple[int, int]:
    """(bytes the request brings, bytes it returns)."""
    return len(frame), len(content)


def check(kept, objects, inputs, job) -> dict[str, tuple[int, int]]:
    """``kept`` is ``[(input index, content)]``, input k the frame of
    object k; ``job.send(frame)`` makes the window's call and raises what
    the program raises.  Each number with its limit."""
    probes = job.rng.choice(len(objects), size=min(len(objects), job.mix["probes"]),
                            replace=False)
    accepted = 0
    for k in probes.tolist():
        try:
            job.send(reference.corrupt(inputs[k], job.rng))
            accepted += 1
        except job.refusal:
            pass
    return {
        "wrong_contents": (sum(out != objects[k] for k, out in kept), 0),
        "objects_unchecked": (len(inputs) - len({k for k, _ in kept}), 0),
        "corrupt_accepted": (accepted, 0),
    }
