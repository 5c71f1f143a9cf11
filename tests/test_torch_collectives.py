"""The int8-compressed collectives (``repro_torch.distributed.collectives``)
against the JAX package's.

``quantize_int8`` / ``dequantize_int8`` are held bitwise on numpy inputs,
float32 and bfloat16 (both divide with IEEE rounding and round half to
even).  ``compressed_psum`` and ``compressed_grad_allreduce`` run on a
gloo group of 8 CPU processes, in a subprocess of their own, against the
reference's 8-device ``shard_map`` run in another, whose mesh takes Auto
axes; both read the same per-rank inputs from a numpy seed and must give
the same means, sums and residuals bit for bit.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import collectives as ref
from repro_torch.distributed import collectives as port

ROOT = Path(__file__).resolve().parents[1]
RANKS = 8
# the subprocesses run beside the suite's other workers: one thread each
# (no result here depends on the thread count)
ONE_THREAD = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _inputs(seed, shape, dtype, case):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "zeros":
        x[:] = 0
    elif case == "tiny":
        x *= 1e-33
    elif case == "halves":
        # values on the rounding boundaries of the codes: x / scale lands on
        # k + 0.5, where round-half-to-even decides
        x = (rng.integers(-127, 127, shape) + 0.5).astype(np.float32)
        x.flat[0] = 127.0
    else:
        x *= 10.0 ** rng.uniform(-4, 4)
    return x.astype(NP_DT[dtype]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "halves"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_is_bitwise_the_reference(dtype, case, seed):
    x = _inputs(seed, (37, 53), dtype, case)
    q_r, s_r = ref.quantize_int8(jnp.asarray(x).astype(dtype))
    q_p, s_p = port.quantize_int8(torch.from_numpy(x).to(TORCH_DT[dtype]))
    assert q_p.dtype == torch.int8 and s_p.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    assert (s_p.float().numpy().tobytes()
            == np.asarray(s_r).astype(np.float32).tobytes())
    d_r = np.asarray(ref.dequantize_int8(q_r, s_r))
    d_p = port.dequantize_int8(q_p, s_p)
    assert d_p.dtype == torch.float32
    assert d_p.numpy().tobytes() == d_r.tobytes()


def test_init_residual_is_float32_zeros_of_each_leaf():
    params = {"w": torch.ones((3, 4), dtype=torch.bfloat16),
              "b": [torch.ones((5,))]}
    res = port.init_residual(params)
    assert res["w"].dtype == torch.float32 and res["w"].shape == (3, 4)
    assert float(res["b"][0].abs().sum()) == 0.0


# the gradient tree of every rank: a float32 matrix, a bfloat16 matrix (the
# port's mean comes back in bf16, as the reference's), a vector, and a
# leaf that is zero on every rank (scale 1e-30)
LEAVES = {"w": ((24, 40), "float32"), "e": ((16, 9), "bfloat16"),
          "b": ((40,), "float32"), "z": ((6,), "float32")}


def _rank_inputs(path):
    rng = np.random.default_rng(7)
    data = {}
    for name, (shape, dt) in LEAVES.items():
        g = (rng.standard_normal((RANKS,) + shape) * 3.0).astype(np.float32)
        r = (rng.standard_normal((RANKS,) + shape) * 1e-2).astype(
            np.float32)
        if name == "z":
            g[:] = 0
            r[:] = 0
        data[f"g_{name}"] = g.astype(NP_DT[dt]).astype(np.float32)
        data[f"r_{name}"] = r
    data["x"] = (rng.standard_normal((RANKS, 33, 17)) * 5).astype(np.float32)
    data["xb"] = data["x"].astype(ml_dtypes.bfloat16).astype(np.float32)
    np.savez(path, **data)


JAX_RUN = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.distributed.collectives import (compressed_grad_allreduce,
                                               compressed_psum)
    leaves = {leaves!r}
    data = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((8,), ("data",), axis_types=(AxisType.Auto,))
    names = sorted(leaves)

    def f(x, xb, *gr):
        g = {{n: gr[i][0].astype(leaves[n][1]) for i, n in enumerate(names)}}
        r = {{n: gr[len(names) + i][0] for i, n in enumerate(names)}}
        mean, new_r = compressed_grad_allreduce(g, "data", r)
        s32 = compressed_psum(x[0], "data")
        s16 = compressed_psum(xb[0].astype(jnp.bfloat16), "data")
        return ((s32[None], s16[None])
                + tuple(mean[n].astype(jnp.float32)[None] for n in names)
                + tuple(new_r[n][None] for n in names))

    n_out = 2 + 2 * len(names)
    fm = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                               out_specs=(P("data"),) * n_out))
    args = [data["x"], data["xb"]] + [data["g_" + n] for n in names] \\
        + [data["r_" + n] for n in names]
    out = fm(*args)
    keys = ["psum32", "psum16"] + ["mean_" + n for n in names] \\
        + ["res_" + n for n in names]
    np.savez(sys.argv[2], **{{k: np.asarray(v) for k, v in zip(keys, out)}})
    print("JAX DONE")
"""

GLOO_RUN = """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    LEAVES = {leaves!r}

    def worker(rank, inp, out_dir, port):
        from repro_torch.distributed.collectives import (
            compressed_grad_allreduce, compressed_psum)
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                                world_size=8, rank=rank)
        data = np.load(inp)
        dt = {{"float32": torch.float32, "bfloat16": torch.bfloat16}}
        g = {{n: torch.from_numpy(data["g_" + n][rank]).to(dt[d])
             for n, (_, d) in LEAVES.items()}}
        r = {{n: torch.from_numpy(data["r_" + n][rank]) for n in LEAVES}}
        mean, new_r = compressed_grad_allreduce(g, None, r)
        assert all(mean[n].dtype == g[n].dtype for n in LEAVES)
        s32 = compressed_psum(torch.from_numpy(data["x"][rank]))
        s16 = compressed_psum(torch.from_numpy(data["xb"][rank]).bfloat16())
        res = {{"psum32": s32, "psum16": s16}}
        res.update({{"mean_" + n: mean[n].float() for n in LEAVES}})
        res.update({{"res_" + n: new_r[n] for n in LEAVES}})
        np.savez(os.path.join(out_dir, f"rank{{rank}}.npz"),
                 **{{k: v.numpy() for k, v in res.items()}})
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.start_processes(worker, args=(sys.argv[1], sys.argv[2],
                                         int(sys.argv[3])),
                           nprocs=8, start_method="spawn")
        print("GLOO DONE")
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(code, name, work, *args, env_extra, timeout):
    """Run ``code`` as the script ``work/name`` (spawned workers import
    their function from it) with ``args``."""
    script = work / name
    script.write_text(textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    res = subprocess.run([sys.executable, str(script), *map(str, args)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_compressed_allreduce_on_8_gloo_ranks_equals_the_reference(
        tmp_path):
    inp = tmp_path / "inputs.npz"
    _rank_inputs(inp)
    want_path = tmp_path / "jax.npz"
    jax_out = _run(JAX_RUN.format(leaves=LEAVES), "jax_run.py", tmp_path,
                   inp, want_path,
                   env_extra={"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                              "--xla_force_host_platform_device_count=8 "
                              + ONE_THREAD},
                   timeout=240)
    assert "JAX DONE" in jax_out
    gloo_out = _run(GLOO_RUN.format(leaves=LEAVES), "gloo_run.py", tmp_path,
                    inp, tmp_path,
                    _free_port(), env_extra={"OMP_NUM_THREADS": "1"},
                    timeout=240)
    assert "GLOO DONE" in gloo_out
    want = np.load(want_path)
    data = np.load(inp)
    for rank in range(RANKS):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].tobytes() == want[k][rank].tobytes(), (rank, k)
    # the all-reduce is a mean of the ranks' (residual-corrected) grads
    # within one code step, and the zero leaf stays exactly zero
    for n in LEAVES:
        gf = data["g_" + n] + data["r_" + n]
        step = np.abs(gf).max() / 127.0
        assert np.abs(want["mean_" + n][0] - gf.mean(0)).max() <= step * 1.01
    assert not want["mean_z"].any()
