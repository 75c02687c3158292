#!/usr/bin/env python3
"""Where decode_v4.cu's and decode_v3.cu's time goes, measured on the card.

    python3 tools/torch_chip_decode_v4_cost.py [--scale 1.0]

decode_v4 (one LZ4 block spread over the card): at each shape, the call's
time (CUDA events, median of five) beside decode_big and decode128, and
the device time of each of its launches (torch.profiler over one call):
walk, verify (the rounds and the scans), place, scatter, every doubling
round (a round that finds nothing left returns at once) and the gather.
Shapes: 3 x 1 MiB + 3 x 4 MiB blocks (phase 2 of chip_smoke.py), one 4 MiB
block of ``mr`` alone, one 64 KiB block of samba behind its 64 KiB prefix,
192 x 64 KiB blocks, and the desync streams that need the serial finish.
Then a sweep of the segment size S (copies of the source with SEG edited;
the kernel carries no switch) at the same shapes.

decode_v3 (one warp a block): copies of the source with WARPS (warps a
CTA), RING (newest output a warp) and SHORT (the longest sequence a lane
copies alone) edited, and one with the batches'
copies taken out (the walk alone), beside decode128, at 192 blocks,
samba's 330 and mozilla's 782 blocks of 64 KiB.

The shared parser (``decode_common.cuh``'s ``parse_seq_with``, the single
sequences of decode128.cu, decode_big.cu and decode_v3.cu): copies of the
header with the tree's one pass, and with ``parse_seq_with`` built from
decode_v4's two halves (``parse_shape`` then ``check_seq``), without and
with ``parse_shape``'s 0xFF-run skip, timed in turns (median of six) in
decode128.cu and decode_big.cu at the shapes above.

Every output but the walk-only one's is checked equal to the library's
decode_v4 / decode_v3 / decode128 / decode_big (themselves held to the
plain version by chip_smoke.py).  Prints the card's name and power limit.
``--part`` runs one section alone.  Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch

import chip_smoke
from lz4tpu_torch import build
from lz4tpu_torch.kernels import decode128 as d128
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels import decompress_v3 as dv3
from lz4tpu_torch.kernels import decompress_v4 as dv4
from lz4tpu_torch.kernels.compress import compress_blocks
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.spec.table import U32Table
from lz4tpu_torch.utils import silesia

BLOCK = 1 << 16
V4_SEG = "constexpr int SEG = 2048;"
V3_GEOMETRY = ("constexpr int WARPS = 1;\n"
               "constexpr int RING = 8192;")
V4_CONFIGS = {f"SEG={s}": {V4_SEG: f"constexpr int SEG = {s};"} for s in (512, 1024, 2048, 4096)}
V3_SHORT = "constexpr int SHORT = 256;"
V3_CONFIGS = {f"WARPS={w},RING={r},SHORT={t}": {
    V3_GEOMETRY: f"constexpr int WARPS = {w};\nconstexpr int RING = {r};",
    V3_SHORT: f"constexpr int SHORT = {t};"}
    for w, r, t in ((1, 8192, 256), (2, 8192, 256), (1, 4096, 256), (1, 8192, 64),
                    (1, 8192, 512), (1, 8192, 1024))}
# where v3's time goes: the walk alone, the batches' copies taken out (its
# output is then wrong, and not checked)
V3_DIAGNOSTIC = {"walk only": {
    "            cp.round_one(bt.e, count, dependent, end_op, lane);": "",
    "            if (dependent) cp.round_two(bt.e, dependent, end_op, lane);": ""}}

# the shared parser's forms, as edits of decode_common.cuh: the tree's one
# pass, and parse_shape + check_seq with or without the 0xFF-run skip
PARSE_SEQ = "template <class Reader>\n__device__ __forceinline__ Seq parse_seq_with("
HALVES = """template <class Reader>
struct ByteRuns {  // the reader with a skip that skips nothing
    const Reader& r;
    __device__ __forceinline__ int operator()(long long i) const { return r(i); }
    __device__ __forceinline__ long long skip_ff(long long i, long long) const { return i; }
};

template <class Reader>
__device__ __forceinline__ Seq parse_seq_with(const Reader& comp, long long n, long long pos,
                                              long long op, long long plen, long long limit,
                                              long long out_cap) {
    const Shape sh = parse_shape(READER, n, pos);
    Seq q;
    q.status = check_seq(sh.code, sh.lit_len, sh.match_len, sh.offset, op, plen, limit, out_cap);
    const bool ok = q.status == OK;
    q.next_pos = sh.next_pos;
    q.lit_src = sh.lit_src;
    q.lit_len = ok ? sh.lit_len : 0;
    q.match_len = ok ? sh.match_len : 0;
    q.offset = ok ? sh.offset : 0;
    return q;
}
"""


def parser_configs():
    """{name: edits of decode_common.cuh} of the shared parser's forms."""
    header = (ROOT / "lz4tpu_torch" / "csrc" / "decode_common.cuh").read_text()
    if header.count(PARSE_SEQ) != 1:
        sys.exit("decode_common.cuh changed: parse_seq_with was not found exactly once")
    start = header.index(PARSE_SEQ)
    tree = header[start : header.index("\n}\n", start) + 3]
    return {"one pass (the tree's)": {},
            "halves": {tree: HALVES.replace("READER", "ByteRuns<Reader>{comp}")},
            "halves, 0xFF runs skipped": {tree: HALVES.replace("READER", "comp")}}


def edited(text: str, edits, what: str) -> str:
    for old, new in edits.items():
        if text.count(old) != 1:
            sys.exit(f"{what} changed: {old!r} was not found exactly once")
        text = text.replace(old, new)
    return text


def start_configs(workdir: pathlib.Path, source: str, entry: str, configs, extra_fns=(),
                  header_edits=None):
    """Start nvcc on each configuration of ``source``, each into its own
    library; ``header_edits`` ({name: edits}) gives a configuration its
    own copy of decode_common.cuh.  ``finish`` waits for them."""
    csrc = ROOT / "lz4tpu_torch" / "csrc"
    src = (csrc / source).read_text()
    header = (csrc / "decode_common.cuh").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, edits in configs.items():
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        d = workdir / f"{pathlib.Path(source).stem}_{tag}"
        d.mkdir()
        if header_edits and name in header_edits:
            (d / "decode_common.cuh").write_text(
                edited(header, header_edits[name], "decode_common.cuh"))
        cu = d / source
        cu.write_text(edited(src, edits, source))
        lib = cu.with_suffix(".so")
        cmd = [nvcc, *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(csrc), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return source, entry, extra_fns, procs


def finish(started):
    """{name: (fn, extras)} of the libraries ``start_configs`` started."""
    source, entry, extra_fns, procs = started
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {source} {name}:\n{out}")
        print(f"{source} {name}: " + " ".join(line.strip() for line in out.splitlines()
                                              if "registers" in line or "spill" in line))
        so = ctypes.CDLL(str(lib))
        fn = getattr(so, entry)
        fn.restype, fn.argtypes = build._SIGNATURES[entry]
        extras = []
        for x in extra_fns:
            f = getattr(so, x)
            f.restype, f.argtypes = build._SIGNATURES[x]
            extras.append(f)
        fns[name] = (fn, extras)
    return fns


def ms_of(fn, reps=5):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def launcher(fn, args, limit, scratch_size=None):
    """A call of one configuration's C entry on ``args``; returns (launch,
    (out, out_len, status))."""
    comp, comp_len, prefix, prefix_len = args
    cap = d128.round_up(limit + comp.shape[1], 16)
    n = len(comp_len)
    out = torch.zeros((n, cap), dtype=torch.uint8, device="cuda")
    out_len = torch.zeros(n, dtype=torch.int32, device="cuda")
    status = torch.zeros(n, dtype=torch.int32, device="cuda")
    stride = 0 if prefix.shape[0] == 1 else prefix.stride(0)
    extra = ()
    if scratch_size is not None:
        size = scratch_size(n, comp.shape[1], cap)
        scratch = torch.empty(max(size, 1), dtype=torch.uint8, device="cuda")
        extra = (scratch.data_ptr(), size)

    def launch():
        out.zero_()
        rc = fn(comp.data_ptr(), comp.stride(0), comp_len.data_ptr(), prefix.data_ptr(), stride,
                prefix.shape[1], prefix_len.data_ptr(), limit, out.data_ptr(), cap,
                out_len.data_ptr(), status.data_ptr(), n, *extra,
                torch.cuda.current_stream().cuda_stream)
        build.check(rc, "configuration")

    return launch, (out, out_len, status)


def passes(call):
    """Device ms of each kernel of one warmed call, by name, and the count
    of launches of each (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = e.key.replace("(anonymous namespace)::", "")
        for short in ("walk", "verify", "place", "scatter", "double", "gather", "Memset",
                      "Fill"):
            if short in key:
                key = short
                break
        ms, count = rows.get(key, (0.0, 0))
        rows[key] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return rows


def v4_shapes(members):
    """{label: (args on the card, limit, out bytes)}."""
    names = list(members)
    out = {}
    sizes = [1 << 20, 4 << 20]
    raws = [chip_smoke.cut_blocks(members[m], s, 1)[0] for s in sizes for m in names[:3]]
    comp, _ = compress_blocks(raws, device="cuda")
    rows = [(c, r) for c, r in zip(comp, raws) if c is not None]
    no = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")

    def batch(blocks, prefixes=None):
        c, cl = pack_rows(blocks, "cuda")
        if prefixes is None:
            return c, cl, no, torch.zeros(len(blocks), dtype=torch.int32, device="cuda")
        p, pl = pack_rows(prefixes, "cuda", align_right=True)
        return c, cl, p, pl

    out["3 x 1 MiB + 3 x 4 MiB"] = (batch([c for c, _ in rows]), 4 << 20,
                                    sum(len(r) for _, r in rows))
    out["one 4 MiB block of mr"] = (batch([rows[-1][0]]), 4 << 20, len(rows[-1][1]))
    samba = members[names[7]]
    row = chip_smoke.cut_blocks(samba, 2 * BLOCK, 3)[1]
    (c,), _ = compress_blocks([row], cursors=[BLOCK], tables=[U32Table()], prime_prefix=True,
                              device="cuda")
    out["one 64 KiB block of samba behind its prefix"] = (batch([c], [row[:BLOCK]]), BLOCK, BLOCK)
    raws = [b for m in names for b in chip_smoke.cut_blocks(members[m], BLOCK, 16)]
    comp, _ = compress_blocks(raws, device="cuda")
    kept = [(c, r) for c, r in zip(comp, raws) if c is not None]
    out["192 x 64 KiB"] = (batch([c for c, _ in kept]), BLOCK, sum(len(r) for _, r in kept))
    desync = chip_smoke.desync_streams()
    out["desync streams (serial finish)"] = (batch(desync), BLOCK, 0)
    return out


def v3_shapes(members):
    names = list(members)
    out = {}
    no = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")
    for label, raws in (
            ("192 blocks", [b for m in names for b in chip_smoke.cut_blocks(members[m], BLOCK, 16)]),
            ("samba's blocks", [members[names[7]][i : i + BLOCK]
                                for i in range(0, len(members[names[7]]), BLOCK)]),
            ("mozilla's blocks", [members[names[1]][i : i + BLOCK]
                                  for i in range(0, len(members[names[1]]), BLOCK)])):
        comp, _ = compress_blocks(raws, device="cuda")
        c, cl = pack_rows([x for x in comp if x is not None], "cuda")
        out[label] = (c, cl, no, torch.zeros(len(cl), dtype=torch.int32, device="cuda"))
    return out


def v4_section(v4, members):
    for label, (targs, limit, n_out) in v4_shapes(members).items():
        want = dv4.decode_v4(*targs, limit)
        bound = (int(targs[1].sum()) + n_out) / chip_smoke.HBM_BYTES_PER_S * 1e3
        times = {"decode_v4": ms_of(lambda: dv4.decode_v4(*targs, limit))}
        if limit <= BLOCK:
            times["decode128"] = ms_of(lambda: d128.decode128(*targs, limit))
        times["decode_big"] = ms_of(lambda: dbig.decode_big(*targs, limit))
        sweep = {}
        for name, (fn, (scratch_size,)) in v4.items():
            launch, got = launcher(fn, targs, limit, scratch_size)
            sweep[name] = ms_of(launch)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"decode_v4 {name} differs from the library's on {label}")
        rows = passes(lambda: dv4.decode_v4(*targs, limit))
        print(f"{label} ({len(targs[1])} blocks, {int(targs[1].sum()):,d} B in, bound "
              f"{bound:.4f} ms): " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
        print(f"  passes ({sum(c for _, c in rows.values())} grid launches): "
              + ", ".join(f"{k} {ms:.3f} ms ({count})" for k, (ms, count) in rows.items()))
        print("  segment sweep: " + ", ".join(f"{k} {v:.3f} ms" for k, v in sweep.items()),
              flush=True)


def v3_section(v3, members):
    for label, targs in v3_shapes(members).items():
        want = dv3.decode_v3(*targs, BLOCK)
        times = {"decode128": ms_of(lambda: d128.decode128(*targs, BLOCK)),
                 "decode_v3": ms_of(lambda: dv3.decode_v3(*targs, BLOCK))}
        for name, (fn, _) in v3.items():
            launch, got = launcher(fn, targs, BLOCK)
            times[name] = ms_of(launch)
            if name not in V3_DIAGNOSTIC and not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"decode_v3 {name} differs from the library's on {label}")
        print(f"{label} ({len(targs[1])} blocks): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)


def parser_section(by_kernel, members):
    """decode128 and decode_big with each form of the shared parser, in
    turns; every form's output equal to the library kernel's."""
    library = {"decode128": d128.decode128, "decode_big": dbig.decode_big}
    for label, (targs, limit, _) in v4_shapes(members).items():
        if label.startswith("desync"):
            continue
        for k, configs in by_kernel.items():
            if k == "decode128" and limit > BLOCK:
                continue
            want = library[k](*targs, limit)
            calls = {}
            for name, (fn, _) in configs.items():
                calls[name], got = launcher(fn, targs, limit)
                calls[name]()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    sys.exit(f"{k} with the parser's form {name!r} differs on {label}")
            at = chip_smoke.in_turns(tuple(calls), calls, rounds=3)
            print(f"{k}, {label}: " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in at.items()),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="Silesia stand-in scale")
    ap.add_argument("--part", choices=("v4", "v3", "parser"), action="append",
                    help="run this section (repeatable; default: all)")
    args = ap.parse_args()
    parts = args.part or ["v4", "v3", "parser"]
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    members = silesia.corpus(args.scale, cache=False)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        started = {}
        if "v4" in parts:
            started["v4"] = start_configs(tmp, "decode_v4.cu", "lz4t_decode_v4", V4_CONFIGS,
                                          ("lz4t_decode_v4_scratch",))
        if "v3" in parts:
            started["v3"] = start_configs(tmp, "decode_v3.cu", "lz4t_decode_v3",
                                          {**V3_CONFIGS, **V3_DIAGNOSTIC})
        if "parser" in parts:
            forms = parser_configs()
            for k in ("decode128", "decode_big"):
                started[k] = start_configs(tmp, f"{k}.cu", f"lz4t_{k}", {f: {} for f in forms},
                                           header_edits=forms)
        built = {key: finish(s) for key, s in started.items()}
        if "v4" in parts:
            print("== decode_v4", flush=True)
            v4_section(built["v4"], members)
        if "v3" in parts:
            print("== decode_v3", flush=True)
            v3_section(built["v3"], members)
        if "parser" in parts:
            print("== the shared parser", flush=True)
            parser_section({k: built[k] for k in ("decode128", "decode_big")}, members)


if __name__ == "__main__":
    main()
