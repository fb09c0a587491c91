"""The PyTorch port stands alone: no module of ``rmm_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax, optax, pandas, networkx, msgpack or
anything of ``rmm_tpu``, and the package imports with those names
blocked."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rmm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pandas", "networkx",
             "msgpack", "rmm_tpu")


def sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_module_imports_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_package_imports_with_forbidden_modules_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import rmm_tpu_torch\n"
        "for info in pkgutil.walk_packages(rmm_tpu_torch.__path__, "
        "'rmm_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
