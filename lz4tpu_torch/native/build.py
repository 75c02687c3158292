"""Builds the native engine (``src/lz4_native.cpp``) into a shared library.

Route: the host C++ compiler (``c++``; ``$CXX`` names another), not
``nvcc``: the engine is plain host code, so it builds wherever the port's
tests run, card or no card.  The library goes to ``lz4tpu_torch/_build/``
(ignored by git), keyed by a hash of the source and flags, and is built at
first use.  Several processes may build at once: each writes its own
temporary file and moves it into place with ``os.replace``.  A failed build
raises; nothing takes the engine's place.  No ``-march=native``: the
library is keyed by source and flags only, so it must run on any CPU of
the architecture that finds it in ``_build/``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

_SRC = pathlib.Path(__file__).parent / "src" / "lz4_native.cpp"
BUILD_DIR = pathlib.Path(__file__).parents[1] / "_build"

CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fno-exceptions", "-fno-rtti",
            "-Wall", "-Wextra"]


def build() -> pathlib.Path:
    """Compile (if stale) and return the path of ``liblz4t_native-<tag>.so``."""
    cxx = os.environ.get("CXX", "c++")
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("|".join([cxx, *CXXFLAGS]).encode())
    lib = BUILD_DIR / f"liblz4t_native-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"tmp-{lib.stem}-{os.getpid()}.so"
    cmd = [cxx, *CXXFLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no compiler of that name
        raise RuntimeError(f"lz4tpu_torch.native: cannot run {cxx}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"lz4tpu_torch.native: the build failed:\n$ {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, lib)
    for old in BUILD_DIR.glob("liblz4t_native-*.so"):
        if old != lib:
            old.unlink(missing_ok=True)
    return lib
