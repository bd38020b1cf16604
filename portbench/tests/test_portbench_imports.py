"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``msd_tpu_torch`` is not ``msd_tpu``."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "msd_tpu"}


def _sources(sub=""):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_levels(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not set(_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "msd_tpu_torch" not in set(_top_levels(path))


def test_names_compared_whole():
    assert "msd_tpu_torch".split(".")[0] not in FORBIDDEN
