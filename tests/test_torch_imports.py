"""The port stands alone: no module of ``raytrace_tpu_torch/``, and not
``chip_smoke.py``, imports ``jax``, ``flax`` or the JAX package
``raytrace_tpu`` (importing it turns on float64 globally, and the card's
machine has no JAX). Each file is parsed with ``ast``; every ``import`` and
``from ... import`` statement counts, wherever it stands (inside a function
too). Relative imports stay inside the port.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "raytrace_tpu_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
FORBIDDEN = ("jax", "flax", "raytrace_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES)
def test_port_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted({n for n in _imported(tree) if _forbidden(n)})
    assert not bad, f"{path} imports {bad}"


def test_the_check_sees_what_it_forbids():
    """The walk finds a nested ``from raytrace_tpu.x import y``, ``import
    jax.numpy`` and ``import flax``, and lets ``raytrace_tpu_torch`` pass."""
    src = ("import numpy\nfrom raytrace_tpu_torch.ops import trace\n"
           "def f():\n    from raytrace_tpu.ops import trace\n    import jax.numpy as jnp\n"
           "    import flax\n")
    found = sorted({n for n in _imported(ast.parse(src)) if _forbidden(n)})
    assert found == ["flax", "jax.numpy", "raytrace_tpu.ops"]
    assert len(FILES) > 40


# the resumable march's tools and the multi-GPU layer
NEW_MODULES = (
    "raytrace_tpu_torch.utils.checkpoint",
    "raytrace_tpu_torch.utils.profiling",
    "raytrace_tpu_torch.utils.progress",
    "raytrace_tpu_torch.parallel",
    "raytrace_tpu_torch.parallel.sharding",
    "raytrace_tpu_torch.parallel.multiprocess_check",
    "raytrace_tpu_torch.parallel.scaling_bench",
)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_where_jax_cannot(module):
    """Each module is one the walk above checks, and imports in a fresh
    interpreter in which ``import jax`` and ``import raytrace_tpu`` fail."""
    import subprocess
    import sys

    path = module.replace(".", "/")
    assert f"{path}.py" in FILES or f"{path}/__init__.py" in FILES
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['raytrace_tpu'] = None\n"
            f"import {module}\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
