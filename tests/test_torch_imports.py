"""The port imports nothing of JAX and nothing of the JAX package, and
neither does ``chip_smoke.py``: the machine with the card has no JAX.

Every Python file of ``comfyui_frame_interpolation_tpu_torch/`` and
``chip_smoke.py`` is parsed and its absolute imports are read (``jax``,
``jaxlib`` and ``comfyui_frame_interpolation_tpu`` are refused); and every
module of the port is imported in a fresh interpreter in which importing
``jax`` fails.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "comfyui_frame_interpolation_tpu_torch"
REFUSED = {"jax", "jaxlib", "comfyui_frame_interpolation_tpu"}


def _port_files():
    files = []
    for dirpath, _, names in os.walk(os.path.join(ROOT, PACKAGE)):
        files += [os.path.relpath(os.path.join(dirpath, n), ROOT) for n in names if n.endswith(".py")]
    return sorted(files) + ["chip_smoke.py"]


def _modules():
    return [f[: -len(".py")].replace(os.sep, ".").removesuffix(".__init__") for f in _port_files() if f.startswith(PACKAGE)]


@pytest.mark.parametrize("path", _port_files())
def test_file_imports_nothing_of_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module)
    assert not {name.split(".")[0] for name in imported} & REFUSED, sorted(imported)


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any import of jax now raises ImportError
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"assert not any(k == 'comfyui_frame_interpolation_tpu' or k.startswith('comfyui_frame_interpolation_tpu.') for k in sys.modules)\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
