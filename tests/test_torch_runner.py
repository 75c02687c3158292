"""The port's resumable sharded runner on CPU meshes (the plain versions),
against the JAX package's runner: round trip, resume, a mismatched
manifest, a truncated archive, the archive byte-equal to the JAX
package's, and two processes that meet through ``torch.distributed``
(gloo) and claim alternate shards."""

import io
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import lz4tpu_torch as lt
from conftest import make_corpus_sample
from lz4tpu import LZ4FrameReader as JaxFrameReader
from lz4tpu.parallel.mesh import make_mesh as jax_make_mesh
from lz4tpu.parallel.runner import run_sharded_compress as jax_run_sharded_compress
from lz4tpu_torch.frame.errors import InputTruncated

REPO = pathlib.Path(__file__).resolve().parent.parent
SHARD = 1 << 17  # two 64 KiB blocks a shard


def cpu_mesh(k):
    return lt.make_mesh(devices=["cpu"] * k)


@pytest.fixture
def corpus(tmp_path):
    """Three shards: two full and one of a single block, with a stretch of
    noise that is stored raw."""
    data = (make_corpus_sample(8600, SHARD + 30_000)
            + np.random.default_rng(8601).integers(0, 256, 70_000, dtype=np.uint8).tobytes()
            + make_corpus_sample(8602, 40_000))
    src = tmp_path / "input.bin"
    src.write_bytes(data)
    return src, data


def test_round_trip_and_resume(tmp_path, corpus):
    src, data = corpus
    out = tmp_path / "out.lz4"
    mesh = cpu_mesh(2)
    stats = lt.run_sharded_compress(src, out, shard_bytes=SHARD, block_size=1 << 16, mesh=mesh)
    assert stats == {"n_shards": 3, "compressed_here": 3, "skipped": 0, "finalized": True,
                     "output_bytes": out.stat().st_size}
    archive = out.read_bytes()

    # resume: delete one shard and the output; only that shard is redone
    (tmp_path / "out.lz4.shards" / "shard-0000001.lz4").unlink()
    out.unlink()
    stats = lt.run_sharded_compress(src, out, shard_bytes=SHARD, block_size=1 << 16, mesh=mesh)
    assert stats["compressed_here"] == 1 and stats["skipped"] == 2 and stats["finalized"]
    assert out.read_bytes() == archive

    back = tmp_path / "back.bin"
    assert lt.run_sharded_decompress(out, back, mesh=cpu_mesh(3)) == {"output_bytes": len(data)}
    assert back.read_bytes() == data

    # frame by frame through the JAX package's streaming reader
    stream = io.BytesIO(archive)
    chunks = [JaxFrameReader(stream, engine="native").read_all() for _ in range(3)]
    assert b"".join(chunks) == data and stream.read() == b""


def test_archive_equals_the_jax_runner(tmp_path, corpus):
    src, _ = corpus
    ours, theirs = tmp_path / "ours.lz4", tmp_path / "theirs.lz4"
    lt.run_sharded_compress(src, ours, shard_bytes=SHARD, block_size=1 << 16, mesh=cpu_mesh(3))
    jax_run_sharded_compress(src, theirs, shard_bytes=SHARD, block_size=1 << 16,
                             mesh=jax_make_mesh(2))
    assert ours.read_bytes() == theirs.read_bytes()
    manifest = (tmp_path / "ours.lz4.shards" / "manifest.json").read_text()
    assert manifest == (tmp_path / "theirs.lz4.shards" / "manifest.json").read_text()


def test_linked_shards_round_trip(tmp_path, corpus):
    src, data = corpus
    out = tmp_path / "out.lz4"
    lt.run_sharded_compress(src, out, shard_bytes=SHARD, block_size=1 << 16, mesh=cpu_mesh(2),
                            parallel_linked=True)
    back = tmp_path / "back.bin"
    lt.run_sharded_decompress(out, back, mesh=cpu_mesh(2))
    assert back.read_bytes() == data


def test_mismatched_manifest_rejected(tmp_path, corpus):
    src, _ = corpus
    out = tmp_path / "out.lz4"
    lt.run_sharded_compress(src, out, shard_bytes=SHARD, block_size=1 << 16, mesh=cpu_mesh(1))
    with pytest.raises(ValueError, match="manifest"):
        lt.run_sharded_compress(src, out, shard_bytes=SHARD // 2, block_size=1 << 16,
                                mesh=cpu_mesh(1))


@pytest.mark.parametrize("cut", [7, 1, 200])
def test_truncated_archive_rejected(tmp_path, corpus, cut):
    src, _ = corpus
    out = tmp_path / "out.lz4"
    lt.run_sharded_compress(src, out, shard_bytes=SHARD, block_size=1 << 16, mesh=cpu_mesh(2))
    trunc = tmp_path / "trunc.lz4"
    trunc.write_bytes(out.read_bytes()[:-cut])
    with pytest.raises(InputTruncated):
        lt.run_sharded_decompress(trunc, tmp_path / "x.bin", mesh=cpu_mesh(2))


WORKER = textwrap.dedent(
    """
    import pathlib, sys
    sys.path.insert(0, {repo!r})
    import lz4tpu_torch as lt
    import torch.distributed as dist

    pid, nproc, workdir = int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3])
    rank, world = lt.initialize_distributed("localhost:{port}", nproc, pid)
    assert (rank, world) == (pid, nproc), (rank, world)
    stats = lt.run_sharded_compress(
        workdir / "input.bin", workdir / "out.lz4", shard_bytes={shard},
        block_size=1 << 16, process_index=rank, process_count=world,
        mesh=lt.make_mesh(devices=["cpu"] * 2), workdir=workdir / "shards", finalize=False)
    dist.barrier()
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lz4tpu"))
    assert not bad, bad
    print("WORKER_OK", pid, stats["compressed_here"], flush=True)
    """
)


def test_two_processes_claim_alternate_shards(tmp_path, corpus):
    src, data = corpus
    (tmp_path / "input.bin").write_bytes(data)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=str(REPO), port=port, shard=SHARD))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    claims = [int(out.split("WORKER_OK")[1].split()[1]) for out in outs]
    assert claims == [2, 1]  # shards 0 and 2, and shard 1

    # process 0's part, run here: every shard exists, so it only joins them
    stats = lt.run_sharded_compress(tmp_path / "input.bin", tmp_path / "out.lz4",
                                    shard_bytes=SHARD, block_size=1 << 16,
                                    mesh=cpu_mesh(1), workdir=tmp_path / "shards")
    assert stats["skipped"] == 3 and stats["finalized"]
    one = tmp_path / "one.lz4"
    lt.run_sharded_compress(tmp_path / "input.bin", one, shard_bytes=SHARD,
                            block_size=1 << 16, mesh=cpu_mesh(1))
    assert (tmp_path / "out.lz4").read_bytes() == one.read_bytes()
    lt.run_sharded_decompress(tmp_path / "out.lz4", tmp_path / "back.bin", mesh=cpu_mesh(2))
    assert (tmp_path / "back.bin").read_bytes() == data
