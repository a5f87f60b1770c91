"""The PyTorch port stands alone: it never imports JAX or the JAX
package, and its entry points never fall back to the CPU silently."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import distributed_pytorch_tpu_torch as port
from distributed_pytorch_tpu_torch.runtime.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "distributed_pytorch_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_pytorch_tpu")


def _forbidden(module: str) -> bool:
    """Exact name or a dotted child: ``distributed_pytorch_tpu_torch``
    shares the JAX package's name as a bare PREFIX and is allowed."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("distributed_pytorch_tpu.ops.flash_attention")
    assert not _forbidden("distributed_pytorch_tpu_torch")
    assert not _forbidden("distributed_pytorch_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, distributed_pytorch_tpu_torch, "
            "distributed_pytorch_tpu_torch.serve, "
            "distributed_pytorch_tpu_torch.ops.flash_attention, "
            "distributed_pytorch_tpu_torch.ops.decode_attention, "
            "distributed_pytorch_tpu_torch.examples.train_resnet\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or "
            "m.startswith(('jax.', 'jaxlib.')) or "
            "m == 'distributed_pytorch_tpu' or "
            "m.startswith('distributed_pytorch_tpu.')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TransformerLM()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.ResNet18()
    assert resolve_device("cpu") == torch.device("cpu")
