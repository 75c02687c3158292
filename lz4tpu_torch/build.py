"""Builds the CUDA kernels into one shared library, cached by source hash.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded
with ctypes (no PyTorch headers, so a build takes seconds).  Every
``csrc/*.cu`` compiles to an object in its own ``nvcc`` process, all
started together, and one ``nvcc -shared`` links them.  The library goes
to ``lz4tpu_torch/_build/`` (ignored by git), keyed by a hash of the
sources and flags, and is built at first use.  The host's own C code
(xxHash32, the native block codec) is ``native/``, built by ``c++``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: seconds the last build took (0.0 when the cached library was reused)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "lz4tpu_torch: nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
        "kernels are built on a machine with the CUDA toolkit"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def build() -> pathlib.Path:
    """Compile (if stale) and return the path of the shared library.  The
    ptxas report (registers, shared memory, spills per kernel) is kept in
    ``_build/build.log``."""
    global build_seconds
    cus, headers = _sources()
    h = hashlib.sha256("|".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"liblz4tpu_torch-{tag}.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj-{tag}-{os.getpid()}"
    work.mkdir(exist_ok=True)
    procs = []
    for src in cus:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"lz4tpu_torch: nvcc failed on {failed}:\n" + "\n".join(log)
        )
    tmp = BUILD_DIR / f"tmp-{tag}-{os.getpid()}.so"
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
    r = subprocess.run(link, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"lz4tpu_torch: link failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    for old in BUILD_DIR.glob("liblz4tpu_torch-*.so"):
        if old != lib:
            old.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib


_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int

_SIGNATURES = {
    # data, data_stride, n, cursor, cap, accel, toff, prime, table_in,
    # table_out, table_slots, out, out_stride, out_len, status, nblocks, stream
    "lz4t_compress": (_I, [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _P, _I64, _P, _P, _I, _P]),
    # comp, comp_stride, comp_len, prefix, prefix_stride, prefix_width,
    # prefix_len, limit, out, out_stride, out_len, status, nblocks, stream
    "lz4t_decode128": (_I, [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _I64,
                            _P, _P, _I, _P]),
    # ..., nblocks, scratch, scratch_bytes, stream
    "lz4t_decode_v4": (_I, [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _I64,
                            _P, _P, _I, _P, _I64, _P]),
    # nblocks, comp_stride, out_stride -> scratch bytes of lz4t_decode_v4
    "lz4t_decode_v4_scratch": (_I64, [_I, _I64, _I64]),
    # nblocks, comp_stride, out_stride -> blocks a group of lz4t_decode_v4 takes
    "lz4t_decode_v4_group": (_I, [_I, _I64, _I64]),
    "lz4t_decode_big": (_I, [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _I64,
                             _P, _P, _I, _P]),
    "lz4t_decode_v3": (_I, [_P, _I64, _P, _P, _I64, _I64, _P, _I64, _P, _I64,
                            _P, _P, _I, _P]),
    # src, base, n, cur0, out, out_stride, out_len, tail_pos, tail_lit, nrows,
    # hashlog, strict, stream
    "lz4t_compress128": (_I, [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _I, _I, _I, _P]),
}


def load():
    """The kernel library (built on first call), with every entry point's
    ctypes signature set: pointers and the stream as ``c_void_p`` so
    64-bit addresses are not cut to 32 bits."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"lz4tpu_torch: {kernel} launch failed with CUDA error {rc}")
