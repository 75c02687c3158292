"""Batched reads: one record batch a request, its buffers' LZ4 frames
decompressed together by ``decompress_frames_parallel`` and returned as a
list of bytes on the host.

The stored frames are the C library's (``reference.stored``, its frame
API at the configuration's settings), made at set-up from the seed's
objects; ``prepare`` groups them in order into batches of the
configuration's ``batch`` frames.  Every kept batch has to equal its
objects, frame by frame.  These frames carry no checksum, so the refusals
are held apart: after the window two probe batches go through the same
call, each with one frame broken, and each has to be refused with the
program's ``LZ4Error``: a frame cut inside its last block, and a frame
whose first match (in its first block) is given the offset 0xFFFF, which
reaches before the frame's first byte.

The mix's control ``{"zero_dictionary": n}`` hands the program ``n`` zero
bytes as every frame's dictionary (``dictionaries=``): a match that
reaches before its frame's first byte then reads the dictionary, and the
offset probe is accepted.
"""

from __future__ import annotations

from lz4bench import reference

SIDE = "decompress"
KINDS = ("truncated", "offset")


def prepare(objects: list[bytes], config: dict) -> list[list[bytes]]:
    """The inputs, one a request: input k is the stored frames of objects
    ``batch * k`` to ``batch * (k + 1) - 1``."""
    frames = reference.stored_frames(objects, config)
    b = config["batch"]
    return [frames[at : at + b] for at in range(0, len(frames), b)]


def call(lt, frames: list[bytes], config: dict, device, control: dict) -> list[bytes]:
    control = dict(control)
    zeros = control.pop("zero_dictionary", 0)
    if zeros:
        control["dictionaries"] = [bytes(zeros)] * len(frames)
    return lt.decompress_frames_parallel(frames, device=device, **control)


def sizes(frames: list[bytes], content) -> tuple[int, int]:
    """(bytes the request brings, bytes it returns); a failed request's
    ``content`` is ``b""``."""
    back = len(content) if isinstance(content, (bytes, bytearray)) else sum(map(len, content))
    return sum(map(len, frames)), back


def first_match(frame: bytes) -> int | None:
    """The position in ``frame`` of the offset of the first match of its
    first block, where that block is compressed, has a match, and the match
    starts less than 0xFFFF bytes into the content; else ``None``."""
    blocks = reference.blocks(frame)
    if not blocks or blocks[0][2]:
        return None
    at, length, _ = blocks[0]
    end = at + length
    lits, at = frame[at] >> 4, at + 1
    if lits == 15:
        while at < end and frame[at] == 255:
            lits += 255
            at += 1
        lits += frame[at] if at < end else 0
        at += 1
    at += lits
    return at if at + 2 <= end and lits < 0xFFFF else None


def probe(kind: str, frames: list[bytes], rng) -> list[bytes] | None:
    """The batch ``frames`` with one frame broken as ``kind`` says, the
    frame drawn from ``rng``; ``None`` where no frame of the batch can be."""
    out = list(frames)
    if kind == "truncated":
        j = int(rng.integers(len(out)))
        at, length, _ = reference.blocks(out[j])[-1]
        out[j] = out[j][: at + int(rng.integers(length))]
        return out
    eligible = [j for j, f in enumerate(out) if first_match(f) is not None]
    if not eligible:
        return None
    j = eligible[int(rng.integers(len(eligible)))]
    at = first_match(out[j])
    out[j] = out[j][:at] + b"\xff\xff" + out[j][at + 2 :]
    return out


def check(kept, objects, inputs, job) -> dict[str, tuple[int, int]]:
    """``kept`` is ``[(input index, contents)]``, input k the frames of
    objects ``batch * k`` on; ``job.send(frames)`` makes the window's call
    and raises what the program raises.  Each number with its limit.  A
    probe that cannot be built (no frame of its batch has a first match)
    counts as accepted."""
    b = job.config["batch"]
    wrong = sum(len(out) != len(inputs[k])
                + sum(o != objects[b * k + j] for j, o in enumerate(out)) for k, out in kept)
    accepted = refused_wrongly = 0
    for i in range(job.mix["probes"]):
        frames = probe(KINDS[i % len(KINDS)], inputs[int(job.rng.integers(len(inputs)))], job.rng)
        if frames is None:
            accepted += 1
            continue
        try:
            job.send(frames)
            accepted += 1
        except job.refusal:
            pass
        except Exception:  # noqa: BLE001 - a refusal of the wrong class is counted
            refused_wrongly += 1
    return {
        "wrong_contents": (wrong, 0),
        "objects_unchecked": (len(objects) - sum(len(inputs[k]) for k, _ in kept), 0),
        "corrupt_accepted": (accepted, 0),
        "wrong_refusal": (refused_wrongly, 0),
    }
