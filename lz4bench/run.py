"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m lz4bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``lz4tpu_torch``.  Set-up makes the
seed's corpus (the configuration's ``corpora/<corpus>.py``), the objects
(the mix's ``objects/<kind>.py``), the inputs (the op's ``prepare``) and one
pass over them (``orders/<kind>.py``), and warms up with that pass.  The
window is a closed loop with one caller: it sends the inputs in the pass's
order, one request at a time, each timed from the call until its bytes are
back on the host, in whole passes until ``--seconds`` have gone.
With ``--trace 1`` the window runs under ``torch.profiler`` and the
per-layer metrics are read from its trace; otherwise the end-to-end ones.
After the window the kept answers are held to the reference (the op's
``check``); each number compared is printed beside its limit on the last
lines of standard error and under ``checks`` in the result.

``--control`` sends the traffic mix's ``control`` arguments with every
call, the program's own path that breaks the configuration's guarantee;
the benchmark's runs never pass it.  ``--device cpu`` (with ``--scale``
below 1) rehearses a run on the kernels' plain versions; it never stands
for a measurement.  Without a card, and without ``--device cpu``, the run
prints no result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from lz4bench import catalog, traffic  # noqa: E402
from lz4bench import trace as tracefile  # noqa: E402

#: top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lz4tpu")
CACHE = catalog.HERE / "cache"


@dataclass
class Request:
    input: int  # index into the op's inputs
    start: float
    end: float
    nbytes_in: int
    nbytes_out: int
    error: str | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read."""

    side: str  # "compress" or "decompress": the op's
    requests: list[Request]
    window_s: float
    setup_s: float
    trace: tracefile.Trace | None = None

    @property
    def done(self) -> list[Request]:
        return [r for r in self.requests if r.error is None]


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m lz4bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.scale != 1.0 and args.device != "cpu":
        p.error("--scale is for rehearsals on the CPU only")
    return args


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None, root: pathlib.Path = catalog.ROOT) -> int:
    args = parse(argv)
    try:
        cell = catalog.cell(args.workload, root)
    except KeyError as e:
        print(f"lz4bench: cell {args.workload!r}: BENCHMARK.json has no {e}", file=sys.stderr)
        return 2
    parts = {}
    mark = T0

    def part(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    import torch

    # the configuration states the size of torch's intra-op pool, where it
    # sets one; the program's own threads are as they are
    if cell.config.get("torch_threads"):
        torch.set_num_threads(cell.config["torch_threads"])
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"lz4bench: {cell.name} needs {cell.chips} CUDA device(s), found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.init()
        kind = torch.cuda.get_device_name(device)
        limit = power_limit()
    else:
        device, kind, limit = torch.device("cpu"), "cpu", None
    import lz4tpu_torch as lt

    part("import")
    members = cell.corpus().members(args.seed, args.scale)
    data = [d for _, d in cell.objects().make(members, cell.traffic, args.seed)]
    del members
    part("corpus")
    op = cell.op()
    inputs = op.prepare(data, cell.config)
    one_pass = cell.order().order(len(inputs), cell.traffic, args.seed)
    part("inputs")
    control = cell.traffic["control"] if args.control else {}

    def send(x):
        return op.call(lt, x, cell.config, device, control)

    send(inputs[one_pass[0]])
    part("warmup_first")
    for k in one_pass[1:]:
        send(inputs[k])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    part("warmup")
    setup_s = time.perf_counter() - T0

    # one answer an input is kept, drawn from the seed among its requests
    # (a reservoir of one): the memory held stays that of one pass
    keep_rng = traffic.rng(args.seed, "keep")
    kept, sent, requests = {}, [0] * len(inputs), []
    profiler = contextlib.nullcontext()
    span = contextlib.nullcontext
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler = profile(activities=acts)
        span = record_function
    with profiler as prof:
        with span(tracefile.WINDOW):
            start = time.perf_counter()
            deadline = start + args.seconds
            i = 0
            while True:
                k = one_pass[i % len(one_pass)]
                with span(f"lz4bench.{op.SIDE}"):
                    t0 = time.perf_counter()
                    try:
                        out, error = send(inputs[k]), None
                    except Exception as e:  # a failed request is counted, not fatal
                        out, error = b"", f"{type(e).__name__}: {e}"
                    t1 = time.perf_counter()
                n_in, n_out = op.sizes(inputs[k], out)
                requests.append(Request(k, t0, t1, n_in, n_out, error))
                if error is None:
                    sent[k] += 1
                    if keep_rng.random() * sent[k] < 1:
                        kept[k] = out
                del out
                i += 1
                if i % len(one_pass) == 0 and t1 >= deadline:
                    break
            window_s = t1 - start
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    part("window")
    run = Run(op.SIDE, requests, window_s, setup_s)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if args.trace:
        CACHE.mkdir(exist_ok=True)
        path = CACHE / f"{cell.name}.trace.json"
        prof.export_chrome_trace(str(path))
        run.trace = tracefile.load(path)
        part("trace")

    job = Job(cell.config, cell.traffic, traffic.rng(args.seed, "check"), send, lt.LZ4Error)
    checks = op.check(sorted(kept.items()), data, inputs, job)
    checks["failed"] = (sum(r.error is not None for r in requests), 0)
    part("check")

    metrics = {}
    for m in cell.metrics:
        if m.end_to_end != bool(args.trace):
            value = cell.reader(m).read(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak, "power_limit": limit}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(requests), "failed": checks["failed"][0],
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}

    bad = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if bad:
        print(f"lz4bench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 4
    lat = sorted(r.seconds * 1e3 for r in run.done)
    print("parts_s " + json.dumps({k: round(v, 4) for k, v in parts.items()}))
    ends = [r.end - start for r in requests[len(one_pass) - 1 :: len(one_pass)]]
    print("passes_s " + json.dumps([round(b - a, 4) for a, b in zip([0.0] + ends, ends)]))
    if len(lat) > 1:
        print(f"requests {len(lat)} in {window_s:.4f} s; ms median {statistics.median(lat):.3f}, "
              f"p95 {statistics.quantiles(lat, n=20, method='inclusive')[18]:.3f}, "
              f"max {lat[-1]:.3f}")
    for r in requests:
        if r.error:
            print(f"failed: input {r.input}: {r.error}")
            break
    sys.stdout.flush()
    for n, (v, lim) in checks.items():
        print(f"check {n} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


@dataclass
class Job:
    """What an op's ``check`` is given besides the answers."""

    config: dict
    mix: dict
    rng: object  # a numpy Generator drawn from the seed
    send: object  # the window's call
    refusal: type  # the program's error for an input it refuses


if __name__ == "__main__":
    sys.exit(main())
