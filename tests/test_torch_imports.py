"""The port stands alone: no module of msd_tpu_torch, and not chip_smoke.py,
imports JAX, any module of msd_tpu, or scikit-learn (the card's machine has
no scikit-learn)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "msd_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "msd_tpu", "flax", "optax", "sklearn")


def test_port_files_exist():
    assert os.path.isfile(os.path.join(ROOT, "chip_smoke.py"))
    assert len(_port_files()) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_msd_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
