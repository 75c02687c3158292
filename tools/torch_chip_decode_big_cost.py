#!/usr/bin/env python3
"""Where a big block's time goes in csrc/decode_big.cu, measured on the card.

    python3 tools/torch_chip_decode_big_cost.py [--scale 0.5]

Builds four variants of the kernel from the source in the tree (the
variants are made here by editing a copy of the source, the kernel itself
carries no switches) and times each on the first 4 MiB of every Silesia
stand-in member, one block per launch:

* ``kernel``: the kernel as it is;
* ``no_copy``: the copy warps skip their copies (barriers kept), so what is
  left is the parse warp's walk and per-entry decode, the barriers, the
  flushes and the window loads;
* ``no_dependent_round``: every match is copied in round one as if it read
  no output of its own batch, and the second round with its barrier is
  gone: what the dependent matches cost;
* ``parse_alone``: one thread walks the block with the shared parser,
  reading device memory, nothing else runs: the floor of a one-thread
  parse, and the count of sequences.

Prints ms and cycles per sequence (at the SM clock nvidia-smi reports).
The outputs of the three cut-down variants are wrong by design; only
``kernel`` is checked, by chip_smoke.py.  Needs one CUDA card and nvcc.
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
from lz4tpu_torch.kernels.compress import compress_blocks
from lz4tpu_torch.kernels.pack import pack_rows
from lz4tpu_torch.utils import silesia

SIZE = 4 << 20

PARSE_ALONE = ("    int op = 0;  // output position", """    {
        if (tid == 0) {
            int p = 0, o2 = 0, count = 0;
            const Window direct{w.g, w.g, 0, 0};  // every byte from device memory
            while (p < n) {
                const lz4t::Seq q = lz4t::parse_seq_with(direct, n, p, o2, plen, limit, out_stride);
                if (q.status != lz4t::OK) break;
                o2 += (int)(q.lit_len + q.match_len);
                p = (int)q.next_pos;
                count++;
            }
            out_len[b] = count;
            status[b] = o2;
        }
        return;
    }
    int op = 0;  // output position""")


def variant_source(src: str, name: str) -> str:
    if name == "no_copy":
        for copy in ("ring[(q.op + j) & RMASK] = (uint8_t)w(q.lit_src + j);",
                     "ring[(mop + j) & RMASK] ="):
            if copy not in src:
                sys.exit("decode_big.cu changed: a copy of the copy warps was not found")
            src = src.replace(copy, "if (false) " + copy)
        return src
    if name == "no_dependent_round":
        for old, new in (("                if ((dependent >> k) & 1) continue;\n", ""),
                         ("            if (dependent) {\n", "            if (false) {\n")):
            if src.count(old) != 1:
                sys.exit(f"decode_big.cu changed: {old!r} was not found exactly once")
            src = src.replace(old, new)
        return src
    if name == "parse_alone":
        old, new = PARSE_ALONE
        if old not in src:
            sys.exit("decode_big.cu changed: the main loop's start was not found")
        return src.replace(old, new, 1)
    return src


def build_variants(workdir: pathlib.Path):
    src = (ROOT / "lz4tpu_torch" / "csrc" / "decode_big.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name in ("kernel", "no_copy", "no_dependent_round", "parse_alone"):
        cu = workdir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        lib = workdir / f"{name}.so"
        cmd = [nvcc, *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-I", str(ROOT / "lz4tpu_torch" / "csrc"), "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{out}")
        fn = ctypes.CDLL(str(lib)).lz4t_decode_big
        fn.restype, fn.argtypes = build._SIGNATURES["lz4t_decode_big"]
        fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.5, help="Silesia stand-in scale")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    mhz = float(smi.stdout.split(",")[2].split()[0])
    members = silesia.corpus(args.scale, cache=False)
    raws = [m[:SIZE] for m in members.values()]
    comp, _ = compress_blocks(raws, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(pathlib.Path(tmp))
        for name, raw, c in zip(members, raws, comp):
            if c is None:
                continue
            rows, lens = pack_rows([c], "cuda")
            cap = -(-(SIZE + rows.shape[1]) // 16) * 16
            out = torch.zeros((1, cap), dtype=torch.uint8, device="cuda")
            out_len = torch.zeros(1, dtype=torch.int32, device="cuda")
            status = torch.zeros(1, dtype=torch.int32, device="cuda")
            prefix = torch.zeros((1, 0), dtype=torch.uint8, device="cuda")
            plen = torch.zeros(1, dtype=torch.int32, device="cuda")
            ms, seqs = {}, 0
            for variant, fn in fns.items():
                times = []
                for _ in range(3):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    rc = fn(rows.data_ptr(), rows.stride(0), lens.data_ptr(), prefix.data_ptr(), 0, 0,
                            plen.data_ptr(), SIZE, out.data_ptr(), cap, out_len.data_ptr(),
                            status.data_ptr(), 1, torch.cuda.current_stream().cuda_stream)
                    b.record()
                    torch.cuda.synchronize()
                    build.check(rc, variant)
                    times.append(a.elapsed_time(b))
                ms[variant] = sorted(times)[1]
                if variant == "parse_alone":
                    seqs = int(out_len[0])  # this variant returns the sequence count
            print(f"{name:8s} {len(raw):>8,d} B, {len(c):>8,d} B compressed, {seqs:>7,d} sequences: "
                  + ", ".join(f"{v} {t:.2f} ms = {t * mhz * 1e3 / max(seqs, 1):.0f} cycles/seq"
                              for v, t in ms.items()), flush=True)


if __name__ == "__main__":
    main()
