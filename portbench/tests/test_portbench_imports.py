"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the reference imports nothing of the port either."""

import ast
import os

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpusim"}


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _modules(sub=""):
    for dirpath, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: _top_level_imports(p) & FORBIDDEN for p in _modules()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_port():
    for path in _modules("reference"):
        names = _top_level_imports(path)
        assert not names & (FORBIDDEN | {"tpusim_torch"}), path
        assert names <= {"__future__", "collections", "typing", "numpy"}, path


def test_a_whole_name_is_compared():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    # the port's name begins with the JAX package's and is allowed
    import tpusim_torch  # noqa: F401

    assert "tpusim_torch" not in loaded_forbidden()
