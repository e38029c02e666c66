"""Import guard for the PyTorch port: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` may import ``jax`` or the JAX package
``repro`` — not even a module of it that has no JAX inside."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom repro.configs import get_config\nimport repro_torch\n"
    tree = ast.parse(src)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert [m for m in mods if _forbidden(m)] == ["jax.numpy", "repro.configs"]


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"            # any `import jax` now raises
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "leaked = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.'))\n"
        "assert not leaked, leaked\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
