"""The port's command line (``lz4tpu_torch.cli.dolz4`` / ``delz4``) on the
CPU: engines ``cpu`` and ``cpu-parallel`` through ``main(argv)``.  The
scalar engine's frames are byte-equal to ``lz4tpu``'s CLI on its native
engine, and every frame round-trips through ``delz4`` and through the JAX
package's reader."""

import io
import random
import types

import pytest

from lz4tpu import decompress_frame as jax_decompress_frame
from lz4tpu.cli import dolz4 as jax_dolz4

from lz4tpu_torch.cli import delz4, dolz4


@pytest.fixture
def inputs(tmp_path, corpus_sample):
    """Paths of a 400 KB input, a 100 KB one and a 20 KB dictionary."""
    data = corpus_sample(6000, 330_000) + random.Random(6001).randbytes(70_000)
    paths = {}
    for name, content in (("data", data), ("small", corpus_sample(6002, 100_000)),
                          ("dict", corpus_sample(6003, 20_000))):
        paths[name] = tmp_path / name
        paths[name].write_bytes(content)
    return paths


def _compress(tool, src, out, *flags):
    assert tool.main([str(src), str(out), *flags]) == 0
    return out.read_bytes()


def _round_trip(frame_path, src, engine, tmp_path, *flags):
    back = tmp_path / f"back-{engine}"
    assert delz4.main([str(frame_path), str(back), "--engine", engine, *flags]) == 0
    assert back.read_bytes() == src.read_bytes()


SCALAR = {
    "default": [],
    "64k_block_checksums": ["--block-size", "65536", "--block-checksums"],
    "linked_256k": ["--block-size", "262144", "--linked-blocks"],
    "no_checksum_no_size_acceleration": ["--no-content-checksum", "--no-content-size",
                                         "--acceleration", "3"],
    "dictionary": ["--block-size", "65536", "--dictionary", "dict", "--dictionary-id", "9"],
    "level_9": ["--level", "9", "--block-size", "65536"],
}


@pytest.mark.parametrize("case", sorted(SCALAR))
def test_cpu_engine_frames_equal_jax_cli(case, inputs, tmp_path):
    flags = [str(inputs["dict"]) if f == "dict" else f for f in SCALAR[case]]
    src = inputs["small" if case == "level_9" else "data"]
    want = _compress(jax_dolz4, src, tmp_path / "jax.lz4", "--engine", "native", *flags)
    got = _compress(dolz4, src, tmp_path / "port.lz4", "--engine", "cpu", *flags)
    assert got == want
    dictionary = ["--dictionary", str(inputs["dict"])] if case == "dictionary" else []
    for engine in ("cpu", "cpu-parallel"):
        _round_trip(tmp_path / "port.lz4", src, engine, tmp_path, *dictionary)


@pytest.mark.parametrize("case", sorted(SCALAR))
def test_native_engine_frames_equal_jax_cli(case, inputs, tmp_path):
    """``--engine native``: the port's host engine writes ``lz4tpu``'s CLI
    frames and reads them back on itself and on the plain versions."""
    flags = [str(inputs["dict"]) if f == "dict" else f for f in SCALAR[case]]
    src = inputs["small" if case == "level_9" else "data"]
    want = _compress(jax_dolz4, src, tmp_path / "jax.lz4", "--engine", "native", *flags)
    got = _compress(dolz4, src, tmp_path / "port.lz4", "--engine", "native", *flags)
    assert got == want
    dictionary = ["--dictionary", str(inputs["dict"])] if case == "dictionary" else []
    for engine in ("native", "cpu"):
        _round_trip(tmp_path / "port.lz4", src, engine, tmp_path, *dictionary)


PARALLEL = {
    "default": [],
    "lane_kernel": ["--lane-kernel"],
    "linked_64k": ["--linked-blocks", "--block-size", "65536"],
    "linked_64k_lane_kernel": ["--linked-blocks", "--block-size", "65536", "--lane-kernel"],
    "dictionary_lane_kernel": ["--dictionary", "dict", "--dictionary-id", "3", "--lane-kernel",
                               "--block-checksums"],
}


@pytest.mark.parametrize("case", sorted(PARALLEL))
def test_cpu_parallel_engine_round_trips(case, inputs, tmp_path):
    flags = [str(inputs["dict"]) if f == "dict" else f for f in PARALLEL[case]]
    src = inputs["data"]
    frame = _compress(dolz4, src, tmp_path / "port.lz4", "--engine", "cpu-parallel", *flags)
    if not flags:
        # an independent frame of the scalar compressor: the streaming writer's bytes
        assert frame == _compress(dolz4, src, tmp_path / "cpu.lz4", "--engine", "cpu")
    dictionary = inputs["dict"].read_bytes() if "--dictionary" in flags else b""
    assert jax_decompress_frame(frame, dictionary=dictionary, engine="native") == src.read_bytes()
    for engine in ("cpu", "cpu-parallel"):
        _round_trip(tmp_path / "port.lz4", src, engine, tmp_path,
                    *(["--dictionary", str(inputs["dict"])] if dictionary else []))


def test_stdin_and_stdout_streams(inputs, tmp_path, monkeypatch, capsys):
    """``-`` reads standard input and writes standard output, for both tools."""
    data = inputs["data"].read_bytes()

    def run(tool, payload, *flags):
        out = io.BytesIO()
        monkeypatch.setattr("sys.stdin", types.SimpleNamespace(buffer=io.BytesIO(payload)))
        monkeypatch.setattr("sys.stdout", types.SimpleNamespace(buffer=out))
        assert tool.main(["-", "-", "--engine", "cpu", *flags]) == 0
        return out.getvalue()

    frame = run(dolz4, data, "-v")
    assert "MB/s" in capsys.readouterr().err
    assert frame == _compress(jax_dolz4, inputs["data"], tmp_path / "jax.lz4", "--engine", "native")
    assert run(delz4, frame) == data


@pytest.mark.parametrize("tool,flags", [
    (dolz4, ["--engine", "cpu-parallel", "--level", "9"]),
    (dolz4, ["--engine", "cpu", "--lane-kernel"]),
    (dolz4, ["--engine", "tpu"]),
    (delz4, ["--engine", "native-parallel"]),
], ids=["level_on_parallel", "lane_kernel_on_scalar", "tpu_engine", "native_engine"])
def test_refused_flags(tool, flags, inputs, tmp_path):
    with pytest.raises(SystemExit):
        tool.main([str(inputs["data"]), str(tmp_path / "out"), *flags])
    assert not (tmp_path / "out").exists()
