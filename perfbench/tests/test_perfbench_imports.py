"""The benchmark measures the port alone: no module under perfbench/
imports JAX, flax or the JAX package (top-level names compared whole), and
the reference imports nothing of the program."""

import ast
import os

from conftest import PERFBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "upp_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(PERFBENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: imported_tops(p) & FORBIDDEN for p in sources()}
    assert not {p: t for p, t in bad.items() if t}


def test_reference_imports_nothing_of_the_program():
    bad = {p: t for p in sources("reference") if (t := imported_tops(p) & {"upp_torch"})}
    assert not bad


def test_top_level_names_are_compared_whole():
    # the port's name begins with the JAX package's; only a whole match counts
    assert "upp_torch" not in FORBIDDEN and "upp_tpu" in FORBIDDEN
