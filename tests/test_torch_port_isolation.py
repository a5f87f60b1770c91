"""The PyTorch port stands alone: it never imports JAX or the JAX
package, and its entry points never fall back to the CPU silently."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import distributed_pytorch_tpu_torch as port
from distributed_pytorch_tpu_torch.data import device_prefetch
from distributed_pytorch_tpu_torch.examples import train_transformer_lm
from distributed_pytorch_tpu_torch.runtime.device import resolve_device
from distributed_pytorch_tpu_torch.serve.pages import PagedSlotPool

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


#: ways of loading a module from a file path, which could reach a JAX
#: package file without an import statement
_BY_PATH = ("spec_from_file_location", "SourceFileLoader", "run_path",
            "load_source", "exec(open")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_loads_a_file_by_path(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not [w for w in _BY_PATH if w in text], path


def test_the_observability_modules_are_the_ports_own():
    """The stdlib-only obs / perfbench modules and the autoscaler are
    copies in the port, loaded from its own tree."""
    import distributed_pytorch_tpu_torch.obs as obs
    import distributed_pytorch_tpu_torch.perfbench as perfbench
    from distributed_pytorch_tpu_torch.serve.fleet import autoscale
    for mod in (obs, obs.trace, obs.metrics, obs.export, obs.detect,
                obs.health, perfbench, perfbench.stats, autoscale):
        assert os.path.commonpath([PKG, mod.__file__]) == PKG, mod


def test_the_fault_layer_is_the_ports_own():
    """The stdlib-only fault and chaos modules (and the elastic and
    multi-host runtime) are the port's copies, loaded from its tree."""
    from distributed_pytorch_tpu_torch.runtime import (chaos, elastic,
                                                       faults, multihost)
    for mod in (faults, chaos, elastic, multihost):
        assert os.path.commonpath([PKG, mod.__file__]) == PKG, mod


def test_importing_the_port_loads_no_jax():
    code = ("import sys, distributed_pytorch_tpu_torch, "
            "distributed_pytorch_tpu_torch.serve, "
            "distributed_pytorch_tpu_torch.ops.flash_attention, "
            "distributed_pytorch_tpu_torch.ops.decode_attention, "
            "distributed_pytorch_tpu_torch.examples.train_resnet, "
            "distributed_pytorch_tpu_torch.examples.train_transformer_lm, "
            "distributed_pytorch_tpu_torch.examples.serve_lm, "
            "distributed_pytorch_tpu_torch.serve.disagg, "
            "distributed_pytorch_tpu_torch.serve.fleet, "
            "distributed_pytorch_tpu_torch.utils.checkpoint, "
            "distributed_pytorch_tpu_torch.utils.profiler, "
            "distributed_pytorch_tpu_torch.serve.pages, "
            "distributed_pytorch_tpu_torch.comm.host_backend, "
            "distributed_pytorch_tpu_torch.comm.hier, "
            "distributed_pytorch_tpu_torch.comm.primitives, "
            "distributed_pytorch_tpu_torch.comm.sanitizer, "
            "distributed_pytorch_tpu_torch.optim.sharded.host, "
            "distributed_pytorch_tpu_torch.optim.sharded.spmd, "
            "distributed_pytorch_tpu_torch.parallel.data_parallel, "
            "distributed_pytorch_tpu_torch.parallel.fsdp, "
            "distributed_pytorch_tpu_torch.parallel.tensor, "
            "distributed_pytorch_tpu_torch.parallel.front_door, "
            "distributed_pytorch_tpu_torch.parallel.spmd, "
            "distributed_pytorch_tpu_torch.ckpt.layout, "
            "distributed_pytorch_tpu_torch.ckpt.manifest, "
            "distributed_pytorch_tpu_torch.ckpt.writer, "
            "distributed_pytorch_tpu_torch.ckpt.reader, "
            "distributed_pytorch_tpu_torch.parallel.sequence, "
            "distributed_pytorch_tpu_torch.parallel.moe, "
            "distributed_pytorch_tpu_torch.parallel.pipeline, "
            "distributed_pytorch_tpu_torch.models.moe_lm, "
            "distributed_pytorch_tpu_torch.examples.train_long_context, "
            "distributed_pytorch_tpu_torch.examples.train_moe_lm, "
            "distributed_pytorch_tpu_torch.obs, "
            "distributed_pytorch_tpu_torch.obs.trace, "
            "distributed_pytorch_tpu_torch.obs.metrics, "
            "distributed_pytorch_tpu_torch.obs.export, "
            "distributed_pytorch_tpu_torch.obs.detect, "
            "distributed_pytorch_tpu_torch.obs.health, "
            "distributed_pytorch_tpu_torch.perfbench, "
            "distributed_pytorch_tpu_torch.perfbench.stats, "
            "distributed_pytorch_tpu_torch.serve.fleet.autoscale, "
            "distributed_pytorch_tpu_torch.runtime.faults, "
            "distributed_pytorch_tpu_torch.runtime.chaos, "
            "distributed_pytorch_tpu_torch.runtime.elastic, "
            "distributed_pytorch_tpu_torch.runtime.multihost, "
            "distributed_pytorch_tpu_torch.runtime.watchdog\n"
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedSlotPool(port.TransformerLM(), 2, 64, page_len=16, n_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_transformer_lm.main_worker(
            0, 1, ["--steps", "1", "--dim", "16", "--n-layers", "1",
                   "--n-heads", "2", "--seq-len", "8", "--data-size", "8"],
            quiet=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_prefetch([])
    assert resolve_device("cpu") == torch.device("cpu")
