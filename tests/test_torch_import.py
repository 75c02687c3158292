"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package, and its entry points never run on the CPU unless asked to."""

import ast
import graphlib
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "lz4tpu_torch"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path, package=None):
    """The modules ``path`` imports anywhere in its code.  With ``package``
    (the module's own package) relative imports are resolved too, and each
    name of ``from X import a`` also counts as ``X.a`` (a submodule, where
    there is one)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                stem = node.module
            elif node.level and package is not None:
                parts = package.split(".")[: package.count(".") + 2 - node.level]
                stem = ".".join(parts + [node.module] if node.module else parts)
            else:
                continue
            yield stem
            if package is not None:
                yield from (f"{stem}.{alias.name}" for alias in node.names)


def _module_name(path):
    return ".".join(path.relative_to(ROOT).with_suffix("").parts)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lz4tpu")


def test_import_leaves_jax_and_lz4tpu_out():
    code = (
        "import sys, lz4tpu_torch, lz4tpu_torch.cli.dolz4, lz4tpu_torch.cli.delz4\n"
        "import lz4tpu_torch.interop, lz4tpu_torch.spec.hc, lz4tpu_torch.native\n"
        "import lz4tpu_torch.parallel.mesh, lz4tpu_torch.parallel.runner\n"
        "import lz4tpu_torch.bench, lz4tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lz4tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_native_engine_loads_without_jax_or_lz4tpu():
    """The host engine builds, loads and runs (a frame through the native
    writer and reader) with neither JAX nor the JAX package imported."""
    code = (
        "import sys, lz4tpu_torch.native as n, lz4tpu_torch as lt\n"
        "data = b'native engine ' * 5000\n"
        "frame = lt.CompressionSettings().engine('native').level(9).compress_bytes(data)\n"
        "assert lt.decompress_frame(frame, engine='native') == data\n"
        "assert n.decompress_block(n.compress_block(data)) == data\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lz4tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_lz4tpu_import_in_source(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_are_one_way():
    """The port's modules (package ``__init__`` files left out) import each
    other without a cycle, imports inside functions included and edges to a
    package's ``__init__`` left out; nothing under ``frame/`` imports
    ``parallel.pipeline``, and no private name crosses between ``frame/``
    and ``parallel/``."""
    paths = {_module_name(p): p for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    imports = {m: set(_imported_modules(p, m.rpartition(".")[0])) for m, p in paths.items()}
    graph = {m: {t for t in targets if t in paths and t != m} for m, targets in imports.items()}
    try:
        tuple(graphlib.TopologicalSorter(graph).static_order())
    except graphlib.CycleError as e:
        pytest.fail(f"import cycle: {e.args[1]}")
    frame, parallel = "lz4tpu_torch.frame.", "lz4tpu_torch.parallel."
    assert not [m for m in graph if m.startswith(frame)
                and "lz4tpu_torch.parallel.pipeline" in graph[m]]
    crossing = [(m, t) for m, targets in imports.items() for t in targets
                for a, b in ((frame, parallel), (parallel, frame))
                if m.startswith(a) and t.startswith(b) and t.rpartition(".")[2].startswith("_")]
    assert not crossing, crossing


def _entry_points(tmp_path):
    import lz4tpu_torch as lt
    from lz4tpu_torch import bench, entry
    from lz4tpu_torch.cli import delz4, dolz4

    frame = lt.compress_frame_parallel(b"abc" * 100, device="cpu")
    (tmp_path / "in").write_bytes(b"abc" * 100)
    (tmp_path / "in.lz4").write_bytes(frame)
    return {
        "compress_frame_parallel": lambda: lt.compress_frame_parallel(b"abc" * 100),
        "decompress_frame_parallel": lambda: lt.decompress_frame_parallel(frame),
        "compress_blocks": lambda: lt.compress_blocks([b"abc" * 100]),
        "compress_block_cuda": lambda: lt.compress_block_cuda(b"abc" * 100),
        "decompress_blocks": lambda: lt.decompress_blocks([b"\x10a"]),
        "decompress_block_cuda": lambda: lt.decompress_block_cuda(b"\x10a"),
        "decompress_blocks_128": lambda: lt.decompress_blocks_128([b"\x10a"]),
        "decompress_blocks_v4": lambda: lt.decompress_blocks_v4([b"\x10a"]),
        "decompress_blocks_big": lambda: lt.decompress_blocks_big([b"\x10a"], 1 << 18),
        "decompress_blocks_v3": lambda: lt.decompress_blocks_v3([b"\x10a"]),
        "decompress_frames_parallel": lambda: lt.decompress_frames_parallel([frame]),
        "compress_frame_parallel_linked": lambda: lt.compress_frame_parallel(
            b"abc" * 100, parallel_linked=True),
        "compress_frame_parallel_lane": lambda: lt.compress_frame_parallel(
            b"abc" * 100, lane_kernel=True),
        "compress_blocks_128": lambda: lt.compress_blocks_128([b"abc" * 100]),
        "CompressionSettings": lambda: lt.CompressionSettings().compress_bytes(b"abc"),
        "decompress_frame": lambda: lt.decompress_frame(frame),
        "compress_block": lambda: lt.compress_block(b"abc" * 100),
        "decompress_block": lambda: lt.decompress_block(b"\x10a"),
        "LZ4FrameReader": lambda: lt.LZ4FrameReader(frame),
        "CompressionSettings_level": lambda: lt.CompressionSettings().level(9).compress_bytes(
            b"abc" * 100),
        "CompressionSettings_linked": lambda: lt.CompressionSettings().independent_blocks(
            False).compress_bytes(b"abc" * 100),
        "dolz4": lambda: dolz4.main([str(tmp_path / "in"), str(tmp_path / "out.lz4")]),
        "delz4": lambda: delz4.main([str(tmp_path / "in.lz4"), str(tmp_path / "out")]),
        "dolz4_parallel": lambda: dolz4.main([str(tmp_path / "in"), str(tmp_path / "out.lz4"),
                                              "--engine", "cuda-parallel"]),
        "make_mesh": lambda: lt.make_mesh(),
        "local_mesh": lambda: lt.local_mesh(),
        "run_sharded_compress": lambda: lt.run_sharded_compress(tmp_path / "in",
                                                                tmp_path / "r.lz4"),
        "run_sharded_decompress": lambda: lt.run_sharded_decompress(tmp_path / "in.lz4",
                                                                    tmp_path / "r.out"),
        "entry": lambda: entry.entry(),
        "dryrun_multichip": lambda: entry.dryrun_multichip(1),
        "bench": lambda: bench.main(["0.125"]),
    }


@pytest.mark.parametrize("name", sorted([
    "compress_frame_parallel", "decompress_frame_parallel", "compress_blocks",
    "compress_block_cuda", "decompress_blocks", "decompress_block_cuda",
    "decompress_blocks_128", "decompress_blocks_v4", "CompressionSettings",
    "decompress_frame", "decompress_blocks_big", "decompress_blocks_v3",
    "decompress_frames_parallel", "compress_frame_parallel_linked",
    "compress_frame_parallel_lane", "compress_blocks_128", "compress_block",
    "decompress_block", "LZ4FrameReader", "CompressionSettings_level",
    "CompressionSettings_linked", "dolz4", "delz4", "dolz4_parallel", "make_mesh",
    "local_mesh", "run_sharded_compress", "run_sharded_decompress", "entry",
    "dryrun_multichip", "bench",
]))
def test_default_device_is_cuda_and_raises_without_it(name, monkeypatch, tmp_path):
    fn = _entry_points(tmp_path)[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means 'cuda'"):
        fn()


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    its kernel (CUDA) or raises."""
    from lz4tpu_torch.kernels.compress import compress_batch
    from lz4tpu_torch.kernels.decode128 import decode128

    meta = torch.device("meta")
    i32 = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        compress_batch(torch.zeros((2, 16), dtype=torch.uint8, device=meta),
                       i32, i32, i32, i32, i32, i32,
                       torch.zeros((2, 4096), dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        decode128(torch.zeros((2, 16), dtype=torch.uint8, device=meta), i32,
                  torch.zeros((1, 0), dtype=torch.uint8, device=meta), i32, 1024)


def test_wrappers_check_dtype_shape_and_device():
    from lz4tpu_torch.kernels.compress import compress_batch
    from lz4tpu_torch.kernels.decode128 import decode128

    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        compress_batch(torch.zeros((2, 16), dtype=torch.int32), i32, i32, i32, i32, i32, i32,
                       torch.zeros((2, 4096), dtype=torch.int32))
    with pytest.raises(ValueError, match="tables"):
        compress_batch(torch.zeros((2, 16), dtype=torch.uint8), i32, i32, i32, i32, i32, i32,
                       torch.zeros((2, 100), dtype=torch.int32))
    with pytest.raises(ValueError, match="comp_len"):
        decode128(torch.zeros((2, 16), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32),
                  torch.zeros((1, 0), dtype=torch.uint8), i32, 1024)
    with pytest.raises(ValueError, match="limit"):
        decode128(torch.zeros((2, 16), dtype=torch.uint8), i32,
                  torch.zeros((1, 0), dtype=torch.uint8), i32, 1 << 20)


def test_chip_smoke_refuses_without_the_package(tmp_path):
    """Alone in a directory, the smoke script fails and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_cuda():
    code = (
        "import sys, runpy, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "sys.argv = ['chip_smoke.py']\n"
        "runpy.run_path('chip_smoke.py', run_name='__main__')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
