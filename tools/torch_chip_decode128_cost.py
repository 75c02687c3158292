#!/usr/bin/env python3
"""decode128.cu's occupancy trade, measured on the card.

    python3 tools/torch_chip_decode128_cost.py [--scale 1.0]

Builds three configurations of csrc/decode128.cu from the source in the
tree (made here by editing the constants of a copy; the kernel itself
carries no switches) and times each, beside decode_big.cu, in four
regimes of 64 KiB blocks:

* ``one block``: one block of samba behind the 64 KiB before it, what a
  wave of one linked frame waits for (phase 5d);
* ``a wave of 207``: 207 blocks, each behind the 64 KiB before it, what a
  wave of phase 4b's and 5c's 207 linked frames holds;
* ``192 blocks``: 16 blocks of each Silesia stand-in member (phase 2's
  shape);
* ``a member``: every block of the largest member, one launch (phase 3).

Configurations: ``kernel`` (as in the tree), ``window_32k`` (32 KiB
stream window, 4 KiB batches and long sequences, two thread blocks an SM),
``window_40k_small_8k`` (40 KiB window, 2 KiB batches, a sequence is long
from 8 KiB, two an SM) and ``window_64k`` (decode_big's geometry: 64 KiB
window, 8 KiB batches and long sequences, one an SM).  Every output
is checked equal to the library's decode128.  Prints ms (median of five) and the
card's name and power limit.  Needs one CUDA card and nvcc.
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

from lz4tpu_torch import build
from lz4tpu_torch.kernels import decode128 as d128
from lz4tpu_torch.kernels import decodebig as dbig
from lz4tpu_torch.kernels.compress import compress_blocks
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.spec.table import U32Table
from lz4tpu_torch.utils import silesia

BLOCK = 1 << 16
GEOMETRY = ("constexpr int CTAS_PER_SM = 3;\n"
            "constexpr int CWIN = 8 << 10;             // compressed-stream window, bytes\n"
            "constexpr int BATCH_BYTES = 1 << 10;      // a batch ends once it holds this much output\n"
            "constexpr int SMALL = 1 << 10;            // longer sequences are a batch of their own\n"
            "constexpr int REFILL_MARGIN = 5 << 9;     // window left for the batch being parsed\n")


def geometry(ctas, cwin, batch_bytes, small, refill):
    return {GEOMETRY: f"constexpr int CTAS_PER_SM = {ctas};\nconstexpr int CWIN = {cwin};\n"
                      f"constexpr int BATCH_BYTES = {batch_bytes};\nconstexpr int SMALL = {small};\n"
                      f"constexpr int REFILL_MARGIN = {refill};\n"}


CONFIGS = {
    "kernel": {},
    "window_32k": geometry(2, 32 << 10, 4 << 10, 4 << 10, 10 << 10),
    "window_40k_small_8k": geometry(2, 40 << 10, 2 << 10, 8 << 10, 12544),
    "window_64k": geometry(1, 64 << 10, 8 << 10, 8 << 10, 20 << 10),
}


def build_configs(workdir: pathlib.Path):
    src = (ROOT / "lz4tpu_torch" / "csrc" / "decode128.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name, edits in CONFIGS.items():
        text = src
        for old, new in edits.items():
            if text.count(old) != 1:
                sys.exit(f"decode128.cu changed: {old!r} was not found exactly once")
            text = text.replace(old, new)
        cu = workdir / f"{name}.cu"
        cu.write_text(text)
        lib = workdir / f"{name}.so"
        cmd = [nvcc, *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(ROOT / "lz4tpu_torch" / "csrc"), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on configuration {name}:\n{out}")
        print(f"{name}: " + " ".join(line.strip() for line in out.splitlines()
                                     if "registers" in line or "spill" in line))
        fn = ctypes.CDLL(str(lib)).lz4t_decode128
        fn.restype, fn.argtypes = build._SIGNATURES["lz4t_decode128"]
        fns[name] = fn
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


def regimes(members):
    """{regime: (comp, comp_len, prefix, prefix_len)} on the card."""
    names = list(members)
    out = {}
    samba = members[names[7]]
    span = max(len(samba) - 2 * BLOCK, 0)
    for label, at in (("one block", len(samba) // 3), ("chip_smoke's block", span // 2)):
        row = samba[at:][: 2 * BLOCK]
        (c,), _ = compress_blocks([row], cursors=[BLOCK], tables=[U32Table()], prime_prefix=True,
                                  device="cuda")
        comp, comp_len = pack_rows([c], "cuda")
        prefix, prefix_len = pack_rows([row[:BLOCK]], "cuda", align_right=True)
        out[label] = (comp, comp_len, prefix, prefix_len)
    data = b"".join(members.values())
    rows = [data[i : i + 2 * BLOCK] for i in range(0, 207 * (len(data) // 208), len(data) // 208)]
    comp_list, _ = compress_blocks(rows, cursors=[BLOCK] * len(rows),
                                   tables=[U32Table() for _ in rows], prime_prefix=True,
                                   device="cuda")
    kept = [(c, r[:BLOCK]) for c, r in zip(comp_list, rows) if c is not None]
    comp, comp_len = pack_rows([c for c, _ in kept], "cuda")
    prefix, prefix_len = pack_rows([p for _, p in kept], "cuda", align_right=True)
    out["a wave of 207"] = (comp, comp_len, prefix, prefix_len)
    for label, raws in (
            ("192 blocks", [d[(len(d) - BLOCK) * j // 15:][:BLOCK] for d in members.values()
                            for j in range(16)]),
            ("a member", [members[max(members, key=lambda m: len(members[m]))][i : i + BLOCK]
                          for i in range(0, len(max(members.values(), key=len)), BLOCK)])):
        comp_list, _ = compress_blocks(raws, device="cuda")
        comp, comp_len = pack_rows([c for c in comp_list if c is not None], "cuda")
        no = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")
        out[label] = (comp, comp_len, no, torch.zeros(len(comp_len), dtype=torch.int32,
                                                      device="cuda"))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0, help="Silesia stand-in scale")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    members = silesia.corpus(args.scale, cache=False)
    cases = regimes(members)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_configs(pathlib.Path(tmp))
        for label, (comp, comp_len, prefix, prefix_len) in cases.items():
            cap = d128.round_up(BLOCK + comp.shape[1], 16)
            want = d128.decode128(comp, comp_len, prefix, prefix_len, BLOCK)
            times = {"decode_big": ms_of(lambda: dbig.decode_big(comp, comp_len, prefix,
                                                                 prefix_len, BLOCK))}
            for name, fn in fns.items():
                out = torch.zeros((len(comp_len), cap), dtype=torch.uint8, device="cuda")
                out_len = torch.zeros(len(comp_len), dtype=torch.int32, device="cuda")
                status = torch.zeros(len(comp_len), dtype=torch.int32, device="cuda")
                stride = 0 if prefix.shape[0] == 1 else prefix.stride(0)

                def launch():
                    rc = fn(comp.data_ptr(), comp.stride(0), comp_len.data_ptr(), prefix.data_ptr(),
                            stride, prefix.shape[1], prefix_len.data_ptr(), BLOCK, out.data_ptr(),
                            cap, out_len.data_ptr(), status.data_ptr(), len(comp_len),
                            torch.cuda.current_stream().cuda_stream)
                    build.check(rc, name)

                times[name] = ms_of(launch)
                if not (torch.equal(out, want[0]) and torch.equal(out_len, want[1])
                        and torch.equal(status, want[2])):
                    sys.exit(f"configuration {name} differs from decode128 on {label}")
            print(f"{label} ({len(comp_len)} blocks, {int(comp_len.sum()):,d} B in): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()), flush=True)


if __name__ == "__main__":
    main()
