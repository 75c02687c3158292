#!/usr/bin/env python3
"""Where a row's time goes in csrc/compress.cu, measured on the card.

    python3 tools/torch_chip_compress_cost.py [--scale 0.5]

Builds variants of the kernel from the source in the tree (made here by
editing a copy of the source; the kernel itself carries no switches) and
times each at three shapes cut from the Silesia stand-in: 50 rows of
64 KiB spread over the members, every 64 KiB block of the largest member in
one launch (more rows than SMs), and one 4 MiB row of each of three members:

* ``kernel``: the kernel as it is (the input read from device memory
  through the L1);
* ``ring``: the input staged in shared memory, a ring of 128 KiB around the
  cursor filled by 16-byte ``cp.async`` copies beside the parse, a read
  outside it going to device memory; one row per SM, so a launch of more
  rows than SMs runs in waves.  Its output is held equal to ``kernel``'s;
* ``no_copies``: literals are not copied to the output (tokens, lengths and
  offsets still are): what the copies cost;
* ``clocks``: the kernel with ``clock64()`` read between the steps of the
  parse in row 0: cycles per sequence spent in the probe batches (schedule;
  load, hash and slot read; claims; candidate read, compare and collision
  vote; hit vote and table writes), the rest of the match extension with
  the backtrack, the ``cursor - 2`` re-insert and the group's output.

The outputs of ``no_copies`` are wrong by design; ``kernel`` is checked by
chip_smoke.py.  Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch

from lz4tpu_torch import build
from lz4tpu_torch.spec.block import compress_bound
from lz4tpu_torch.utils import silesia

STEPS = ("schedule", "load+hash+slot", "claims", "candidate+collisions", "vote+insert",
         "extension+backtrack", "re-insert", "output")

# the ``ring`` variant's input, in place of the kernel's ``struct Input``
RING_INPUT = r'''constexpr int RING = 1 << 17;   // the input ring, bytes
constexpr int CHUNK = 1 << 12;  // it is filled in such pieces
constexpr int LAND_AFTER = 4;   // batches a fill may stay in flight
static_assert(MAX_DISTANCE + 1 + 2 * CHUNK <= RING, "ring smaller than the match window");

// The row's bytes.  Positions are shifted by `skew` (the row's base modulo
// 16) so that q = p + skew is 16-byte aligned in device memory wherever it
// is in the ring; the ring holds q in [lo, hi), both multiples of 16.
struct Input {
    const uint32_t* g;  // device memory, aligned words: byte q is in g[q >> 2]
    const uint32_t* ring;
    int skew, end;      // the row is q in [skew, end)
    int last_word;      // (end - 1) >> 2
    int lo, hi;
    int flying;         // bytes past hi whose copies are in flight
    int age;            // batches since they were started

    // one load, whichever memory holds the word, and no branch: the address
    // is chosen as a number and read through a generic pointer
    __device__ __forceinline__ uint32_t word(int wi) const {
        const bool staged = (unsigned)((wi << 2) - lo) < (unsigned)(hi - lo);
        const uintptr_t at = staged ? (uintptr_t)ring + ((uintptr_t)(wi & (RING / 4 - 1)) << 2)
                                    : (uintptr_t)g + ((uintptr_t)wi << 2);
        return *reinterpret_cast<const uint32_t*>(at);
    }
    __device__ __forceinline__ uint32_t rd8(int p) const {
        const int q = p + skew;
        return (word(q >> 2) >> ((q & 3) * 8)) & 0xFF;
    }
    __device__ __forceinline__ uint32_t rd32(int p) const {
        const int q = p + skew, wi = q >> 2, sh = (q & 3) * 8;
        return __funnelshift_r(word(wi), word(min(wi + 1, last_word)), sh);
    }
    __device__ __forceinline__ uint64_t rd64(int p) const {
        const int q = p + skew, wi = q >> 2, sh = (q & 3) * 8;
        const uint32_t a = word(wi), b = word(wi + 1), c = word(min(wi + 2, last_word));
        return (uint64_t)__funnelshift_r(a, b, sh) | ((uint64_t)__funnelshift_r(b, c, sh) << 32);
    }
    __device__ __forceinline__ int end16() const { return (end + 15) & ~15; }
    // start copying the next piece behind hi (and behind what is in flight)
    __device__ __forceinline__ void fill(int lane) {
        const int from = hi + flying;
        const int len = min(CHUNK, end16() - from);
        __syncwarp();  // no lane still reads the slots this piece takes
        for (int q = from + 16 * lane; q < from + len; q += 16 * THREADS) {
            uint8_t* d = reinterpret_cast<uint8_t*>(const_cast<uint32_t*>(ring)) + (q & (RING - 1));
            const uint8_t* s = reinterpret_cast<const uint8_t*>(g) + q;
            if (q >= skew && q + 16 <= end) {
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                                 (uint32_t)__cvta_generic_to_shared(d)), "l"(s) : "memory");
            } else {  // the row's first and last bytes
                for (int i = 0; i < 16; i++)
                    if (q + i >= skew && q + i < end) d[i] = s[i];
            }
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        lo = max(lo, from + len - RING);
        flying += len;
        age = 0;
    }
    // make what is in flight readable
    __device__ __forceinline__ void land() {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncwarp();
        hi += flying;
        flying = 0;
    }
    // before a batch at position p: keep the ring as far ahead as it can be
    // without losing a byte of the 64 KiB behind p
    __device__ __forceinline__ void advance(int p, int lane) {
        const int q = p + skew;
        const int keep = max(q - (int)MAX_DISTANCE - 1, 0);
        if (keep > hi + flying) {  // the parse jumped past the ring: restart it
            if (flying) land();
            lo = hi = keep & ~15;
        }
        if (flying && (q + 64 > hi || ++age >= LAND_AFTER)) land();
        while (hi + flying < end16() &&
               hi + flying + min(CHUNK, end16() - hi - flying) - RING <= keep)
            fill(lane);
    }
};

'''
RING_EDITS = [
    ("                                            const Input& in, int n,\n",
     "                                            Input& in, int n,\n"),
    ("    using slot_t = typename T::slot_t;\n",
     "    using slot_t = typename T::slot_t;\n    in.advance(min(init_cursor, n), lane);\n"
     "    if (in.flying) in.land();\n"),
    ("            // every lane loads, a lane past the tail",
     "            in.advance(__shfl_sync(FULL, p, 0), lane);\n"
     "            // every lane loads, a lane past the tail"),
    ("    Input in;\n    in.skew = (int)((uintptr_t)row & 3);\n"
     "    in.g = reinterpret_cast<const uint32_t*>(row - in.skew);\n"
     "    in.last_word = max(n + in.skew - 1, 0) >> 2;\n",
     "    extern __shared__ __align__(16) uint8_t ring_bytes[];\n    Input in;\n"
     "    in.skew = (int)((uintptr_t)row & 15);\n"
     "    in.g = reinterpret_cast<const uint32_t*>(row - in.skew);\n"
     "    in.ring = reinterpret_cast<const uint32_t*>(ring_bytes);\n"
     "    in.end = max(n, 0) + in.skew;\n    in.last_word = max(in.end - 1, 0) >> 2;\n"
     "    in.lo = in.hi = in.flying = in.age = 0;\n"),
    ("    compress_kernel<T><<<nblocks, THREADS, 0, s>>>(",
     "    cudaFuncSetAttribute(compress_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, "
     "RING);\n    compress_kernel<T><<<nblocks, THREADS, RING, s>>>("),
]

# (text to find, text to put in its place); each must occur exactly once
CLOCKS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long lz4t_ticks[16];\n"
     "#define TICK(i) do { const long long now_ = clock64(); acc_[i] += now_ - last_; "
     "last_ = now_; } while (0)\n"),
    ("    long long op = 0;\n    int cursor = min(init_cursor, n);\n",
     "    long long op = 0;\n    int cursor = min(init_cursor, n);\n"
     "    long long acc_[12] = {0}, last_ = clock64(), batches_ = 0, seqs_ = 0;\n"),
    ("            // every lane loads, a lane past the tail",
     "            TICK(0); batches_++;\n            // every lane loads, a lane past the tail"),
    ("            if (!past) claim[h] = (uint8_t)lane;\n",
     "            TICK(1);\n            if (!past) claim[h] = (uint8_t)lane;\n"),
    ("            // What the probe finds in its slot",
     "            TICK(2);\n            // What the probe finds in its slot"),
    ("            const unsigned hits = __ballot_sync(FULL, hit);\n",
     "            TICK(3);\n            const unsigned hits = __ballot_sync(FULL, hit);\n"),
    ("            __syncwarp();\n            if (first_hit < THREADS) {\n",
     "            __syncwarp();\n            TICK(4);\n            if (first_hit < THREADS) {\n"),
    ("                extra = matching - (int)MINMATCH + back;\n",
     "                TICK(5);\n                extra = matching - (int)MINMATCH + back;\n"),
    ("                __syncwarp();\n                break;\n",
     "                __syncwarp();\n                TICK(6); seqs_++;\n                break;\n"),
    ("        op = put_lsic(out, op + 2, extra, lane);\n",
     "        op = put_lsic(out, op + 2, extra, lane);\n        TICK(7);\n"),
    ("    if (lane == 0) {\n        *out_len = (int32_t)op;\n",
     "    if (lane == 0 && blockIdx.x == 0) {\n"
     "        for (int i = 0; i < 8; i++) atomicAdd(&lz4t_ticks[i], (unsigned long long)acc_[i]);\n"
     "        atomicAdd(&lz4t_ticks[9], (unsigned long long)batches_);\n"
     "        atomicAdd(&lz4t_ticks[10], (unsigned long long)seqs_);\n    }\n"
     "    if (lane == 0) {\n        *out_len = (int32_t)op;\n"),
]
READ_TICKS = """
extern "C" int lz4t_ticks_read(unsigned long long* dst) {
    unsigned long long zero[16] = {0};
    cudaError_t e = cudaMemcpyFromSymbol(dst, lz4t_ticks, sizeof(zero));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(lz4t_ticks, zero, sizeof(zero));
}
"""
EDITS = {
    "kernel": [],
    "ring": RING_EDITS,
    "no_copies": [("    if (len <= 0) return;\n", "    return;\n")],
    "clocks": CLOCKS,
}


def variant_source(src: str, name: str) -> str:
    if name == "ring":
        start, end = src.find("// The row's bytes, read as aligned"), src.find("// U32 table:")
        if start < 0 or end < start:
            sys.exit("compress.cu changed: the ring variant did not find struct Input")
        src = src[:start] + RING_INPUT + src[end:]
    for old, new in EDITS[name]:
        if src.count(old) != 1:
            sys.exit(f"compress.cu changed: variant {name} did not find {old!r} exactly once")
        src = src.replace(old, new)
    return src + (READ_TICKS if name == "clocks" else "")


def build_variants(workdir: pathlib.Path):
    src = (ROOT / "lz4tpu_torch" / "csrc" / "compress.cu").read_text()
    nvcc = build._nvcc()
    procs = {}
    for name in EDITS:
        cu = workdir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        lib = workdir / f"{name}.so"
        cmd = [nvcc, *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on variant {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].lz4t_compress.restype, libs[name].lz4t_compress.argtypes = \
            build._SIGNATURES["lz4t_compress"]
    libs["clocks"].lz4t_ticks_read.restype = ctypes.c_int
    libs["clocks"].lz4t_ticks_read.argtypes = [ctypes.c_void_p]
    return libs


class Rows:
    """One launch's tensors on the card: rows at cursor 0, U32 tables, cap =
    row length, as the frame writer launches independent blocks."""

    def __init__(self, rows):
        n = len(rows)
        width = -(-max(map(len, rows)) // 16) * 16
        arr = np.zeros((n, width), np.uint8)
        for i, r in enumerate(rows):
            arr[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens = [len(r) for r in rows]

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device="cuda")

        self.data = torch.from_numpy(arr).cuda()
        self.scalars = [i32(lens), i32([0] * n), i32(lens), i32([1] * n), i32([0] * n),
                        i32([0] * n)]
        self.tables = torch.zeros((n, 4096), dtype=torch.int32, device="cuda")
        self.table_out = torch.empty_like(self.tables)
        self.cap = -(-compress_bound(width) // 16) * 16
        self.out = torch.zeros((n, self.cap), dtype=torch.uint8, device="cuda")
        self.out_len = torch.zeros(n, dtype=torch.int32, device="cuda")
        self.status = torch.zeros(n, dtype=torch.int32, device="cuda")
        self.n = n

    def launch(self, lib):
        rc = lib.lz4t_compress(
            self.data.data_ptr(), self.data.stride(0), *(t.data_ptr() for t in self.scalars),
            self.tables.data_ptr(), self.table_out.data_ptr(), 4096, self.out.data_ptr(),
            self.cap, self.out_len.data_ptr(), self.status.data_ptr(), self.n,
            torch.cuda.current_stream().cuda_stream)
        build.check(rc, "compress variant")

    def ms(self, lib, reps=3):
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.launch(lib)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.5, help="Silesia stand-in scale")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    members = silesia.corpus(args.scale, cache=False)
    names = list(members)
    largest = max(members.values(), key=len)
    spread = [m[(len(m) - 65536) * j // 4 :][:65536] for m in members.values() for j in range(5)]
    shapes = {
        "50 x 64 KiB": Rows(spread[:50]),
        "largest member in 64 KiB rows": Rows([largest[i : i + 65536]
                                               for i in range(0, len(largest), 65536)]),
    }
    for name in (names[0], names[1], names[-1]):
        shapes[f"one 4 MiB row of {name}"] = Rows([members[name][: 4 << 20]])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(pathlib.Path(tmp))
        for label, rows in shapes.items():
            ms = {name: rows.ms(lib) for name, lib in libs.items() if name != "clocks"}
            rows.launch(libs["kernel"])
            want = (rows.out.clone(), rows.out_len.clone(), rows.table_out.clone())
            rows.out.zero_()
            rows.launch(libs["ring"])
            if not all(torch.equal(a, b) for a, b in
                       zip(want, (rows.out, rows.out_len, rows.table_out))):
                sys.exit(f"the ring variant's output differs from the kernel's at {label}")
            print(f"{label} ({rows.n} rows): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()),
                  flush=True)
        ticks = (ctypes.c_ulonglong * 16)()
        for label, rows in shapes.items():
            build.check(libs["clocks"].lz4t_ticks_read(ticks), "ticks")  # zero the counters
            rows.launch(libs["clocks"])
            torch.cuda.synchronize()
            build.check(libs["clocks"].lz4t_ticks_read(ticks), "ticks")
            batches, seqs = max(ticks[9], 1), max(ticks[10], 1)
            print(f"{label}, row 0: {seqs:,d} sequences, {batches:,d} probe batches, "
                  f"{sum(ticks[:8]) / seqs:.0f} cycles a sequence: "
                  + ", ".join(f"{s} {ticks[i] / seqs:.0f}" for i, s in enumerate(STEPS)),
                  flush=True)


if __name__ == "__main__":
    main()
