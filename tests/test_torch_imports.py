"""The port stands alone: no file of ``src/repro_torch``,
``chip_smoke.py`` or ``tools/run_training_phases.py`` imports JAX or the
JAX package, and none imports the
CUDA extension builder or Triton at module level (importing the port on
a machine without nvcc must not build anything). ``chip_smoke.py``
refuses to run without a card."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "run_training_phases.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node, node.module


def test_port_files_exist():
    assert len(FILES) > 20
    assert all(f.is_file() for f in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for _, name in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_build_tools_import_lazily():
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [name for node, name in _imports(tree)
               if node in tree.body]
        assert not [n for n in top if n.startswith(
            ("torch.utils.cpp_extension", "triton"))], path


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without CUDA the smoke script exits non-zero and prints no
    result on its standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA is not available" in res.stderr
