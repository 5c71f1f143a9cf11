"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points refuse to run on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _port_modules():
    out = []
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(PORT.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(out)


def test_importing_the_port_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from repro_torch.device import resolve
    from repro_torch.models import gnn
    from repro_torch.core import runtime

    assert resolve("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn.build_dense("sgc", "CO", scale=0.02)
    b = gnn.build_dense("sgc", "CO", scale=0.02, device="cpu")
    out, _ = b.run(runtime.DynasparseEngine())
    assert out.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    import repro_torch.kernels as K
    from repro_torch.kernels import ops
    from repro_torch.core.perf_model import Primitive

    K.reset_launch_counts()
    x = torch.ones((20, 24))
    y = torch.ones((24, 8))
    for p in Primitive:
        ops.matmul(x, y, p, tile=(16, 16))
    ops.csr_spmm(x, y, rmax=24)
    assert all(v == 0 for v in K.launch_counts().values())
