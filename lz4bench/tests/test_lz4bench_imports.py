"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference side imports nothing of the program either."""

import ast
import json
import subprocess
import sys

import pytest

from lz4bench import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "lz4tpu"}
# only these files may import the program under test
CALLERS = {"run.py", "write.py", "read.py"}


def imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(catalog.HERE.rglob("*.py")), ids=lambda p: p.name)
def test_sources(path):
    found = imports(path)
    assert not found & FORBIDDEN
    if path.name not in CALLERS and path.parent.name != "tests":
        assert "lz4tpu_torch" not in found


def test_program_is_imported_inside_main_only():
    # import of run.py does not load the program; main() does
    code = ("import json, sys, lz4bench.run; print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('lz4tpu_torch', 'torch'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=catalog.ROOT, check=True).stdout
    assert json.loads(out) == []
