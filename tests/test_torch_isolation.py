"""The PyTorch port stands alone: no module of tpusim_torch, nor
chip_smoke.py, imports JAX or the JAX package, and the package imports
without PyYAML (the GPU machine has none)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tpusim_torch")


def port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tpusim_imports(path):
    assert os.path.exists(path)
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpusim"), f"{path}: {mod}"


def test_package_imports_without_yaml():
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import tpusim_torch.cli, tpusim_torch.backend, "
            "tpusim_torch.backends, tpusim_torch.simulator, "
            "tpusim_torch.workloads, tpusim_torch.kernels.build\n"
            "assert 'jax' not in sys.modules and 'tpusim' not in sys.modules\n"
            "assert 'triton' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
