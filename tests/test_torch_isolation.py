"""The PyTorch port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package
``repro`` (checked on the source by AST, and by importing every module of
the port in a fresh interpreter), and its entry points run on the GPU
unless asked for the CPU — without a card they raise instead of falling
back."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))
    assert "repro_torch.serving.engine" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(get_smoke_config("qwen2-0.5b"), torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke"])
    # a CUDA tensor never reaches the plain version silently: the kernel
    # library cannot even be built here
    from repro_torch.kernels.build import nvcc_path
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            nvcc_path()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda_or_repo(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when
    there is no card, or when it stands in a directory without the repo."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
