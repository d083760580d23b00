"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points refuse a CUDA device that is not there."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "print(len(mods), bad)\n"
        "assert len(mods) > 20 and not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_sources_import_nothing_forbidden(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path.name}:{node.lineno} imports {roots}"


def test_cuda_manager_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import CheckpointConfig, CheckpointManager, theta_like

    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(CheckpointConfig(root=str(tmp_path), cluster=theta_like(2, 2)))


def test_cuda_control_plane_without_a_gpu_raises(tmp_path):
    """The plane's tenants run on the card unless the caller passes
    ``device="cpu"``: without a GPU, registering a tenant raises and
    leaves no record behind."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.control import ControlPlane
    from repro_torch.core import theta_like

    cp = ControlPlane(str(tmp_path), flush_bw_cap=1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp.register_job("job", theta_like(2, 2), codec="none")
    assert cp.jobs() == [] and cp.limiter.tenants() == []
    assert not (tmp_path / "control" / "registry.json").exists()
    cp.close()


def test_cuda_tensor_never_takes_the_plain_path():
    """Without a card the wrappers cannot be handed a CUDA tensor at all;
    on a meta tensor (neither CPU nor CUDA) they raise."""
    from repro_torch.kernels import (
        checksum_u32,
        dequantize,
        digest_array,
        fused_precodec,
        quantize,
        xor_delta,
    )

    x = torch.empty(2048, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_precodec(x, x, chunk_words=1024)
    with pytest.raises(ValueError, match="no kernel for device"):
        quantize(torch.empty(4096, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        checksum_u32(x)
    with pytest.raises(ValueError, match="no kernel for device"):
        digest_array(torch.empty(99, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        xor_delta(x, x)
    with pytest.raises(ValueError, match="no kernel for device"):
        dequantize(torch.empty((4, 128), dtype=torch.int8, device="meta"),
                   torch.empty(4, device="meta"), n=500)
