"""Rehearsals of whole runs on the CPU (``--device cpu``, a tiny corpus):
the result line, the comparison, the control and the faults it catches."""

import json
import shutil
import subprocess
import sys

import pytest

import lz4tpu_torch
from lz4bench import catalog
from lz4bench.run import main

CELLS = [w["name"] for w in catalog.load()["workloads"]]
TINY = ["--seconds", "0.3", "--device", "cpu", "--scale", "0.0005"]


def rehearse(capsys, cell, *extra, seed=11):
    assert main(["--workload", cell, "--seed", str(seed), *TINY, *extra]) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(capsys, cell):
    result, err = rehearse(capsys, cell, seed=2**31 + 99)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 12
    assert set(result["metrics"]) == {m.name for m in catalog.cell(cell).metrics if m.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    # each number compared beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert tail == [f"check {n} {c['value']} limit {c['limit']}"
                    for n, c in result["checks"].items()]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(capsys, cell):
    result, _ = rehearse(capsys, cell, "--trace", "1")
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the device's metrics find nothing to read
    wanted = {m.name for m in catalog.cell(cell).metrics if not m.end_to_end}
    assert set(result["metrics"]) <= wanted
    assert not any(k.startswith(("device_idle", "kernel_roofline", "link_gbps"))
                   for k in result["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    result, _ = rehearse(capsys, cell, "--control")
    assert result["correct"] is False
    failing = {n for n, c in result["checks"].items() if c["value"] > c["limit"]}
    assert failing == ({"wrong_frames"} if "write" in cell else {"corrupt_accepted"})


def entry(cell):
    """The name of the program's function that the cell's op calls: the one
    attribute its ``call`` reads from the package it is handed."""
    read = []

    class Package:
        def __getattr__(self, name):
            read.append(name)
            return lambda *a, **k: b""

    c = catalog.cell(cell)
    c.op().call(Package(), b"", c.config, "cpu", {})
    assert len(read) == 1 and callable(getattr(lz4tpu_torch, read[0])), read
    return read[0]


def unchanged(real, writes):
    """The input handed back as the answer: a batch's frames each as it came."""
    return lambda x, *a, **k: [bytes(f) for f in x] if isinstance(x, list) else bytes(x)


def half_left_out(real, writes):
    """A write of half the object; a read of half the content, or of half
    the batch's frames."""
    if writes:
        return lambda x, *a, **k: real(x[: len(x) // 2], *a, **k)
    return lambda x, *a, **k: (lambda out: out[: len(out) // 2])(real(x, *a, **k))


def altered(real, writes):
    """One byte flipped in the answer, or in the middle frame's answer of a batch."""
    def flip(answer):
        out = bytearray(answer)
        out[len(out) // 2] ^= 1
        return bytes(out)

    def call(x, *a, **k):
        out = real(x, *a, **k)
        if isinstance(out, list):
            return [flip(o) if j == len(out) // 2 else o for j, o in enumerate(out)]
        return flip(out)
    return call


def answers_wrong(result):
    """The count of wrong answers that the run compared: ``wrong_frames`` of
    a write, ``wrong_contents`` of a read."""
    checks = result["checks"]
    return checks["wrong_frames" if "wrong_frames" in checks else "wrong_contents"]["value"]


def test_entry_is_the_one_each_op_calls():
    assert {c: entry(c) for c in CELLS} == {
        "silesia-64k-read": "decompress_frame_parallel",
        "silesia-4m-write": "compress_frame_parallel",
        "silesia-4m-read": "decompress_frame_parallel",
        "silesia-64k-write": "compress_frame_parallel",
        "silesia-64k-readbatch": "decompress_frames_parallel",
    }


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", ["silesia-64k-read", "silesia-4m-write", "silesia-64k-readbatch"])
def test_faults_in_the_timed_path_are_caught(capsys, monkeypatch, cell, fault):
    name = entry(cell)
    monkeypatch.setattr(lz4tpu_torch, name, fault(getattr(lz4tpu_torch, name), "write" in cell))
    result, _ = rehearse(capsys, cell)
    assert result["correct"] is False
    assert result["failed"] == 0 and answers_wrong(result) > 0


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "lz4bench.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=catalog.ROOT)
    assert p.returncode == 3 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(catalog.HERE, tmp_path / "lz4bench", ignore=shutil.ignore_patterns("cache"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "lz4bench.run", "--workload", CELLS[0],
                        "--seed", "1", *TINY], capture_output=True, text=True, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, capsys, cell):
    """The control at the cell's own size, on the card, three seeds."""
    for seed in (101, 2**31 + 7, 987654321):
        assert main(["--workload", cell, "--seed", str(seed), "--seconds", "3",
                     "--control"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with capsys.disabled():
            print(cell, seed, json.dumps(result["checks"]))
        assert result["correct"] is False


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_on_the_card(card, capsys, monkeypatch, cell):
    """One byte altered where the answer is made, at the cell's own size,
    on the card, three seeds: the upper reading of the answers' count.
    The fault goes into the entry point that the cell's op calls."""
    name = entry(cell)
    monkeypatch.setattr(lz4tpu_torch, name, altered(getattr(lz4tpu_torch, name), "write" in cell))
    for seed in (202, 2**31 + 8, 876543210):
        assert main(["--workload", cell, "--seed", str(seed), "--seconds", "3"]) == 0
        out, _ = capsys.readouterr()
        result = json.loads(out.strip().splitlines()[-1])
        with capsys.disabled():
            print(cell, seed, name, json.dumps(result["checks"]))
        assert result["correct"] is False
        assert result["failed"] == 0 and answers_wrong(result) > 0
