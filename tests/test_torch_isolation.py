"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package, and importing it builds or loads no kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "triton_dist_tpu_torch"
MODULES = ["triton_dist_tpu_torch", "triton_dist_tpu_torch.csrc",
           "triton_dist_tpu_torch.utils", "triton_dist_tpu_torch.ops",
           "triton_dist_tpu_torch.models", "triton_dist_tpu_torch.parallel",
           "triton_dist_tpu_torch.parallel.mesh",
           "triton_dist_tpu_torch.parallel.pipeline",
           "triton_dist_tpu_torch.ops.ring_attention",
           "triton_dist_tpu_torch.serving", "triton_dist_tpu_torch.shmem",
           "triton_dist_tpu_torch.layers"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "triton_dist_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_the_port(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['triton_dist_tpu'] = None\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "from triton_dist_tpu_torch import csrc\n"
            "assert csrc._libs == {}, 'a kernel was loaded at import'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke run fails and prints no result; copied away
    from the repository it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
