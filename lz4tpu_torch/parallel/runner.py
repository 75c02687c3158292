"""Resumable large-corpus runner: shard a huge input over processes and
cards, compress block-parallel, gather frames in order, survive restarts.

Counterpart of ``lz4tpu/parallel/runner.py``, for the 100 GB corpus of
``BASELINE.md``: the frame format's independent blocks make every shard a
self-contained problem, so a crashed run redoes only unfinished shards.
Each shard becomes one LZ4 frame (frames end themselves and concatenate
back to back), so the output is a multi-frame ``.lz4`` file that any
standard reader decodes.  With the same ``shard_bytes`` and ``block_size``
the archive of an independent run is byte-identical to the JAX package's.

Multiple processes: every process calls ``run_sharded_compress`` with the
same arguments but its own ``process_index`` (from
``mesh.initialize_distributed``); shard ``s`` is claimed by the process
with ``s % process_count == process_index``.  Progress lives in a work
directory: a manifest, and one ``shard-NNNNNNN.lz4`` per finished shard,
published atomically; process 0 joins them in order once all exist.  No
coordination beyond the filesystem.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import tempfile

from ..frame.decompress import LZ4FrameReader
from ..frame.format import read_block, read_checksum
from .mesh import make_mesh
from .pipeline import compress_frame_parallel, decompress_frame_parallel


def run_sharded_compress(
    input_path,
    output_path,
    *,
    shard_bytes: int = 256 << 20,
    block_size: int = 1 << 16,
    process_index: int = 0,
    process_count: int = 1,
    mesh=None,
    workdir=None,
    parallel_linked: bool = False,
    finalize: bool = True,
) -> dict:
    """Compress ``input_path`` into a multi-frame ``.lz4`` at ``output_path``.

    Resumable: a shard whose file exists is skipped.  ``mesh=None`` means
    ``make_mesh()``, every card of this process (raising without one).
    Returns ``{"n_shards", "compressed_here", "skipped"}``, plus
    ``"finalized"`` and ``"output_bytes"`` where process 0 joined the
    archive.  A work directory whose manifest differs from this run's
    arguments is refused with ``ValueError``.
    """
    input_path = pathlib.Path(input_path)
    output_path = pathlib.Path(output_path)
    total = input_path.stat().st_size
    n_shards = max(-(-total // shard_bytes), 1)

    workdir = pathlib.Path(workdir) if workdir else output_path.parent / (
        output_path.name + ".shards"
    )
    workdir.mkdir(parents=True, exist_ok=True)
    manifest_path = workdir / "manifest.json"
    manifest = {
        "input": str(input_path),
        "total_bytes": total,
        "shard_bytes": shard_bytes,
        "block_size": block_size,
        "n_shards": n_shards,
        "parallel_linked": parallel_linked,
    }
    if manifest_path.exists():
        old = json.loads(manifest_path.read_text())
        if {k: old.get(k) for k in manifest} != manifest:
            raise ValueError(
                f"existing manifest at {manifest_path} does not match this run's "
                "parameters; use a fresh workdir"
            )
    else:
        manifest_path.write_text(json.dumps(manifest, indent=2))

    if mesh is None:
        mesh = make_mesh()

    done = skipped = 0
    with open(input_path, "rb") as f:
        for shard in range(process_index, n_shards, process_count):
            shard_file = workdir / f"shard-{shard:07d}.lz4"
            if shard_file.exists():
                skipped += 1
                continue
            f.seek(shard * shard_bytes)
            frame = compress_frame_parallel(f.read(shard_bytes), block_size=block_size,
                                            mesh=mesh, parallel_linked=parallel_linked)
            # atomic publish, so that a crash never leaves half a shard
            with tempfile.NamedTemporaryFile(dir=workdir, delete=False) as tmp:
                tmp.write(frame)
            os.replace(tmp.name, shard_file)
            done += 1

    stats = {"n_shards": n_shards, "compressed_here": done, "skipped": skipped}
    if finalize and process_index == 0:
        shard_files = [workdir / f"shard-{i:07d}.lz4" for i in range(n_shards)]
        if all(p.exists() for p in shard_files):
            with tempfile.NamedTemporaryFile(dir=output_path.parent, delete=False) as out:
                for p in shard_files:
                    out.write(p.read_bytes())
            os.replace(out.name, output_path)
            stats["finalized"] = True
            stats["output_bytes"] = output_path.stat().st_size
    return stats


def _frame_end(stream, dev) -> int:
    """Where the frame at ``stream``'s position ends, found by walking its
    block chain; every read is length-checked, so a truncated archive
    raises ``InputTruncated``.  Block sizes are left to the decode."""
    flags = LZ4FrameReader(stream, engine=dev).flags  # parses the header
    while read_block(stream, flags, 0xFFFFFFFF) is not None:  # no maxsize check
        pass
    read_checksum(stream, flags.content_checksum)
    return stream.tell()


def run_sharded_decompress(input_path, output_path, mesh=None) -> dict:
    """Decode a multi-frame ``.lz4`` file frame by frame, in order, each
    frame's blocks over the mesh (``mesh=None``: every card of this
    process).  Returns ``{"output_bytes"}``."""
    if mesh is None:
        mesh = make_mesh()
    data = pathlib.Path(input_path).read_bytes()
    stream = io.BytesIO(data)
    out_total = 0
    with open(output_path, "wb") as out:
        pos = 0
        while pos < len(data):
            end = _frame_end(stream, mesh.devices[0])
            chunk = decompress_frame_parallel(data[pos:end], mesh=mesh)
            out.write(chunk)
            out_total += len(chunk)
            pos = end
    return {"output_bytes": out_total}
