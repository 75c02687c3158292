"""What a run is made of, found by name from ``BENCHMARK.json``.

Each piece is a file of its own, so that a later change adds a piece by
adding files and entries and edits none:

* a cell is an entry of ``workloads`` in ``BENCHMARK.json``;
* a configuration is the JSON file its ``configs`` entry names; its
  ``corpus`` names the generator of its data, ``corpora/<corpus>.py``,
  whose ``members(seed, scale)`` gives ``{name: bytes}``;
* a traffic mix is ``traffic/<name>.json``, a file of parameters (see
  ``traffic.py``) that names three pieces more: its ``objects``
  (``objects/<kind>.py``, whose ``make(corpus, mix, seed)`` cuts the
  corpus into the objects, each with a name), its ``order``
  (``orders/<kind>.py``, whose ``order(n, mix, seed)`` gives one pass over
  the inputs) and its ``op`` (``ops/<op>.py``: the inputs made from the
  objects, the call, and the check of the answers);
* a metric, end-to-end or per-layer, is ``metrics/<name>.py``, whose
  ``read(run)`` gives its number, or ``None`` where the run has nothing
  for it to read.  An end-to-end metric without ``workloads`` is every
  cell's; a per-layer metric lists its cells under ``workloads``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    end_to_end: bool


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: tuple[Metric, ...]  # end-to-end first, then per-layer
    base: pathlib.Path  # the benchmark's folder

    def part(self, kind: str, name: str):
        """The module ``<kind>/<name>.py`` of the benchmark's folder."""
        return load_module(self.base / kind / f"{name}.py", kind)

    def corpus(self):
        return self.part("corpora", self.config["corpus"])

    def objects(self):
        return self.part("objects", self.traffic["objects"])

    def order(self):
        return self.part("orders", self.traffic["order"])

    def op(self):
        return self.part("ops", self.traffic["op"])

    def reader(self, metric: Metric):
        return self.part("metrics", metric.name)


def load_module(path: pathlib.Path, kind: str):
    """Import one file of the benchmark by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"lz4bench._{kind}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and the metrics it
    reports; ``KeyError`` when ``BENCHMARK.json`` has no such cell."""
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    base = root / HERE.name
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{work['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    metrics = tuple(Metric(m["name"], m["unit"], True) for m in e2e) + tuple(
        Metric(m["name"], m["unit"], False) for m in layer)
    return Cell(name, work["chips"], config, traffic, metrics, base)
