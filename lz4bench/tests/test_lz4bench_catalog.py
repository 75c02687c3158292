"""Every piece is found by name, and a cell added as files is picked up."""

import json
import shutil

import pytest

from lz4bench import catalog
from lz4bench.run import main

END_TO_END = {m["name"]: m for m in catalog.load()["end_to_end"]}


def test_every_file_that_benchmark_json_names_is_there():
    bench = catalog.load()
    for cfg in bench["configs"]:
        conf = json.loads((catalog.ROOT / cfg["file"]).read_text())
        assert conf["name"] == cfg["name"] and conf["reduced"] == cfg["reduced"]
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell.traffic["name"] == w["traffic"]
        assert hasattr(cell.op(), "call") and hasattr(cell.op(), "check")
        names = {m.name for m in cell.metrics}
        assert "setup_s" in names and len(names) >= 3
        for m in cell.metrics:
            assert callable(cell.reader(m).read)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (catalog.HERE / "metrics" / f"{m['name']}.py").exists()
    # a per-layer metric names the cells that report it
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells


@pytest.mark.parametrize("name", list(END_TO_END))
def test_end_to_end_bound_is_a_share_up_to_a_quarter(name):
    assert 0 < END_TO_END[name]["bound"] <= 0.25


@pytest.mark.parametrize("name", list(END_TO_END))
def test_end_to_end_workloads_are_cells(name):
    cells = {w["name"] for w in catalog.load()["workloads"]}
    listed = END_TO_END[name].get("workloads", sorted(cells))
    assert listed and len(set(listed)) == len(listed) and set(listed) <= cells


def test_each_cell_reports_its_side_only():
    cell = catalog.cell("silesia-64k-read")
    names = {m.name for m in cell.metrics}
    assert {"decompress_mbps", "read_p95_ms", "device_idle.decompress"} <= names
    assert not any(n.endswith(".compress") or n.startswith("compress") for n in names)


def add_cell(root):
    """A cell, a configuration, a traffic mix and a metric, added as files
    and entries only, to a copy of the benchmark under ``root``."""
    shutil.copytree(catalog.HERE, root / "lz4bench", ignore=shutil.ignore_patterns("cache"))
    bench = catalog.load()
    conf = json.loads((catalog.HERE / "configs" / "lz4f-64k-indep.json").read_text())
    conf.update(name="lz4f-256k-indep", block_size=1 << 18)
    (root / "lz4bench" / "configs" / "lz4f-256k-indep.json").write_text(json.dumps(conf))
    mix = dict(name="write-members-again", why="added", op="write", objects="members",
               order="permutation", control={"lane_kernel": True})
    (root / "lz4bench" / "traffic" / "write-members-again.json").write_text(json.dumps(mix))
    (root / "lz4bench" / "metrics" / "writes_per_s.py").write_text(
        "def read(run):\n    return len(run.done) / run.window_s\n")
    bench["configs"].append(dict(name="lz4f-256k-indep", source="https://example.org/x",
                                 file="lz4bench/configs/lz4f-256k-indep.json", reduced=[],
                                 why="added"))
    bench["workloads"].append(dict(name="silesia-256k-write", config="lz4f-256k-indep",
                                   traffic="write-members-again", chips=1, why="added"))
    bench["end_to_end"].append(dict(name="writes_per_s", unit="1/s", better="higher",
                                    bound=0.05, source="host_clock",
                                    workloads=["silesia-256k-write"]))
    for m in bench["end_to_end"]:
        if m["name"] in ("compress_mbps", "stored_ratio"):
            m["workloads"].append("silesia-256k-write")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_added_as_files_is_picked_up(tmp_path, capsys):
    add_cell(tmp_path)
    cell = catalog.cell("silesia-256k-write", tmp_path)
    assert cell.config["block_size"] == 1 << 18
    assert {m.name for m in cell.metrics} == {"compress_mbps", "stored_ratio", "writes_per_s",
                                              "setup_s"}
    rc = main(["--workload", "silesia-256k-write", "--seed", "3", "--seconds", "0.2",
               "--device", "cpu", "--scale", "0.0005"], root=tmp_path)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["attempted"] % 12 == 0
    assert set(result["metrics"]) == {"compress_mbps", "stored_ratio", "writes_per_s", "setup_s"}


def run_added(root, cell, capsys):
    rc = main(["--workload", cell, "--seed", str(2**31 + 5), "--seconds", "0.2",
               "--device", "cpu", "--scale", "0.0005"], root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def add_entries(root, cell, config, traffic):
    bench = catalog.load(root)
    bench["workloads"].append(dict(name=cell, config=config, traffic=traffic, chips=1,
                                   why="added"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("decompress_mbps", "read_p95_ms", "launches_per_req.decompress"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_mix_of_small_objects_is_data_alone(tmp_path, capsys):
    """Small reads: objects cut from the members, as one data file."""
    shutil.copytree(catalog.HERE, tmp_path / "lz4bench", ignore=shutil.ignore_patterns("cache"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    mix = dict(name="read-small", why="added", op="read", objects="cuts", sizes=[64, 2048],
               count=40, order="permutation", probes=2, control={"verify_checksums": False})
    (tmp_path / "lz4bench" / "traffic" / "read-small.json").write_text(json.dumps(mix))
    add_entries(tmp_path, "silesia-small-read", "lz4f-64k-indep", "read-small")
    cell = catalog.cell("silesia-small-read", tmp_path)
    objs = cell.objects().make(cell.corpus().members(9, 0.0005), cell.traffic, 9)
    again = cell.objects().make(cell.corpus().members(10, 0.0005), cell.traffic, 10)
    assert len(objs) == 40 and all(64 <= len(d) <= 2048 for _, d in objs)
    assert [len(d) for _, d in objs] == [len(d) for _, d in again]  # sizes: not the seed's
    assert [d for _, d in objs] != [d for _, d in again]
    result = run_added(tmp_path, "silesia-small-read", capsys)
    assert result["correct"] is True and result["attempted"] % 40 == 0
    assert set(result["metrics"]) == {"decompress_mbps", "read_p95_ms", "setup_s"}


def test_new_kinds_of_corpus_objects_and_order_are_files(tmp_path, capsys):
    """A corpus, an objects kind and an order, each added as a file."""
    shutil.copytree(catalog.HERE, tmp_path / "lz4bench", ignore=shutil.ignore_patterns("cache"))
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path)
    base = tmp_path / "lz4bench"
    (base / "corpora" / "ramps.py").write_text(
        "def members(seed, scale):\n"
        "    return {f'ramp{i}': bytes((j * (i + 1) + seed) % 251 for j in range(3000))\n"
        "            for i in range(3)}\n")
    (base / "objects" / "halves.py").write_text(
        "def make(corpus, mix, seed):\n"
        "    return [(f'{n}/{h}', d[h * len(d) // 2:(h + 1) * len(d) // 2])\n"
        "            for n, d in corpus.items() for h in (0, 1)]\n")
    (base / "orders" / "reverse.py").write_text(
        "def order(n, mix, seed):\n    return list(range(n))[::-1]\n")
    conf = json.loads((base / "configs" / "lz4f-4m-indep.json").read_text())
    conf.update(name="lz4f-4m-ramps", corpus="ramps")
    (base / "configs" / "lz4f-4m-ramps.json").write_text(json.dumps(conf))
    mix = dict(name="read-halves", why="added", op="read", objects="halves", order="reverse",
               probes=1, control={"verify_checksums": False})
    (base / "traffic" / "read-halves.json").write_text(json.dumps(mix))
    bench = catalog.load(tmp_path)
    bench["configs"].append(dict(name="lz4f-4m-ramps", source="https://example.org/x",
                                 file="lz4bench/configs/lz4f-4m-ramps.json", reduced=[],
                                 why="added"))
    bench["workloads"].append(dict(name="ramps-read", config="lz4f-4m-ramps",
                                   traffic="read-halves", chips=1, why="added"))
    for m in bench["end_to_end"]:
        if m["name"] == "decompress_mbps":
            m["workloads"].append("ramps-read")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = catalog.cell("ramps-read", tmp_path)
    assert len(cell.objects().make(cell.corpus().members(1, 1.0), cell.traffic, 1)) == 6
    assert cell.order().order(6, cell.traffic, 1) == [5, 4, 3, 2, 1, 0]
    result = run_added(tmp_path, "ramps-read", capsys)
    assert result["correct"] is True and result["attempted"] % 6 == 0
    assert set(result["metrics"]) == {"decompress_mbps", "setup_s"}
