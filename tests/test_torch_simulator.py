"""The port's cost-model simulator (``build_sim``, ``simulate``) against the
JAX package, on the CPU, at full Table VI scale.

Both packages generate the block statistics with numpy from the same seed,
so ``block_stats``, ``weight_stats`` and the propagated statistics must be
bitwise equal.  Planning rounds the float64 densities to float32 in both
(the reference through ``jnp.asarray``), and costs and schedules are
float64 numpy in both, so every kernel's histogram and makespan must be
EXACTLY the reference's, under the FPGA model and the TPU model alike.
Reference simulations are the slow part of this file (op-by-op ``jnp``),
so the grid is sampled: every strategy on CI, CO and PU, two on the large
graphs.  Then the reference's own simulator cases run inside the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analyzer as r_analyzer
from repro.core import runtime as r_runtime
from repro.core.perf_model import TPUCostModel as RTPU
from repro.data import graphs as r_graphs
from repro.models import gnn as r_gnn
from repro_torch.core import analyzer as p_analyzer
from repro_torch.core import runtime as p_runtime
from repro_torch.core.perf_model import TPUCostModel as PTPU
from repro_torch.data import graphs as p_graphs
from repro_torch.models import gnn as p_gnn

MODELS = ("gcn", "sage", "gin", "sgc")
STRATEGIES = ("dynamic", "s1", "s2", "gemm")
_SIMS: dict = {}


def _sims(model: str, ds: str, **kw):
    """(reference, port) bundles, built once per file and argument set."""
    key = (model, ds, tuple(sorted(kw.items())))
    if key not in _SIMS:
        _SIMS[key] = (r_gnn.build_sim(model, ds, **kw),
                      p_gnn.build_sim(model, ds, device="cpu", **kw))
    return _SIMS[key]


def _same_stats(p, r, what):
    assert p.shape == r.shape and p.block == r.block, what
    assert p.density == r.density, what
    assert p.block_densities.dtype == r.block_densities.dtype, what
    np.testing.assert_array_equal(p.block_densities, r.block_densities,
                                  err_msg=what)


def _same_report(p, r, what):
    assert p.strategy == r.strategy
    assert [k.name for k in p.kernels] == [k.name for k in r.kernels], what
    for pk, rk in zip(p.kernels, r.kernels):
        np.testing.assert_array_equal(pk.histogram, rk.histogram,
                                      err_msg=f"{what} {pk.name}")
        assert pk.makespan_cycles == rk.makespan_cycles, (what, pk.name)
        assert pk.num_tasks == rk.num_tasks, (what, pk.name)
        assert pk.utilization == rk.utilization, (what, pk.name)
        assert pk.k2p_seconds == rk.k2p_seconds, (what, pk.name)


@pytest.mark.parametrize("ds", list(p_graphs.TABLE_VI))
@pytest.mark.parametrize("n1,n2", [(256, 64), (512, 128)])
def test_block_stats_bitwise(ds, n1, n2):
    r = r_graphs.block_stats(ds, n1, n2, seed=3)
    p = p_graphs.block_stats(ds, n1, n2, seed=3)
    assert list(p) == list(r)
    for name in r:
        _same_stats(p[name], r[name], f"{ds} {name}")


@pytest.mark.parametrize("density", [1.0, 0.3, 0.05])
def test_weight_stats_bitwise(density):
    for dims, names in (([500, 16, 3], None), ([61278, 128], ["Wself1"])):
        r = r_graphs.weight_stats(dims, 32, density, seed=2, names=names)
        p = p_graphs.weight_stats(dims, 32, density, seed=2, names=names)
        assert list(p) == list(r)
        for name in r:
            _same_stats(p[name], r[name], name)


def _check_cell(model, ds, strategies, cost_models=((None, None),)):
    r, p = _sims(model, ds)
    assert list(p.stats) == list(r.stats)
    for name in r.stats:                    # propagate_stats included
        _same_stats(p.stats[name], r.stats[name], f"{model}/{ds} {name}")
    for rm, pm in cost_models:
        for s in strategies:
            _same_report(p.simulate(s, model=pm), r.simulate(s, model=rm),
                         f"{model}/{ds}/{s}/{type(pm).__name__}")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("ds", ["CI", "CO", "PU"])
def test_simulate_small_graphs_all_strategies(model, ds):
    _check_cell(model, ds, STRATEGIES)


@pytest.mark.parametrize("model", ["gcn", "sage"])
@pytest.mark.parametrize("ds", ["FL", "NE", "RE"])
def test_simulate_large_graphs(model, ds):
    _check_cell(model, ds, ("dynamic", "s1"))


@pytest.mark.parametrize("ds", ["CI", "RE"])
def test_simulate_tpu_model_dynamic(ds):
    """Under the TPU model a dense weight makes SpDMM and SPMM cost the
    same in exact arithmetic; the port's simulator plans in the order the
    reference's simulator runs (as written), so the ties break alike."""
    _check_cell("sage", ds, ("dynamic",), ((RTPU(), PTPU()),))


def test_simulate_refuses_attention_and_needs_a_device():
    _, p = _sims("gcn", "CO")
    with pytest.raises(NotImplementedError):
        p_gnn.build_sim("gat", "CO", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_gnn.build_sim("gcn", "CO")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_runtime.simulate_inference(p.compiled, p.stats)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataclasses.replace(p, device=None).simulate("dynamic")


# ---- the reference's simulator cases, inside the port ---------------------

def test_dynamic_mapping_dominates_static():
    """tests/test_core_system.py:110: dynamic K2P <= min(S1, S2)."""
    for model in ("gcn", "sage"):
        sim = _sims(model, "CI")[1]
        lat = {s: sim.simulate(s).total_cycles
               for s in ("dynamic", "s1", "s2")}
        assert lat["dynamic"] <= min(lat["s1"], lat["s2"]) * 1.02


def test_dynamic_skips_empty_partitions():
    """tests/test_core_system.py:120."""
    sim = _sims("gcn", "CI")[1]
    assert sim.simulate("dynamic").histogram[0] > 0
    assert sim.simulate("s2").histogram[0] == 0


def test_runtime_overhead_modeled():
    """tests/test_core_system.py:128: K2P time linear in the decisions."""
    rep = _sims("gcn", "PU")[1].simulate("dynamic")
    assert 0 < rep.k2p_seconds < 0.05
    ratios = [k.k2p_seconds / int(k.histogram.sum()) for k in rep.kernels]
    assert max(ratios) - min(ratios) < 1e-12


def test_pruning_increases_dynamic_advantage():
    """tests/test_core_system.py:142: Table VIII's trend."""
    so = []
    for dens in (1.0, 0.3, 0.05):
        sim = p_gnn.build_sim("gcn", "PU", weight_density=dens,
                              device="cpu")
        dyn = sim.simulate("dynamic").total_cycles
        so.append(sim.simulate("s1").total_cycles / dyn)
    assert so[0] < so[1] < so[2]


@pytest.mark.parametrize("name", ["CI", "CO", "PU"])
def test_block_stats_match_table_vi(name):
    """tests/test_serving_and_data.py:91."""
    spec = p_graphs.TABLE_VI[name]
    stats = p_graphs.block_stats(name, 256, 64)
    a = stats["A"]
    mean_d = float(np.average(a.block_densities,
                              weights=np.ones_like(a.block_densities)))
    assert mean_d == pytest.approx(spec.density_a, rel=3.0, abs=5e-3)
    assert stats["H0"].density == pytest.approx(spec.density_h0, rel=0.5,
                                                abs=2e-3)


def test_build_sim_rejects_gat():
    """tests/test_gat_attention.py:159."""
    with pytest.raises(NotImplementedError):
        p_gnn.build_sim("gat", "CO", device="cpu")
    spec = p_gnn.make_model_spec("gat", 16, 8, 4)
    assert dataclasses.asdict(spec)["model"] == "gat"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_histogram_matches_host_planner(strategy):
    """tests/test_unified_executor.py:64: the engine's planner (inside the
    executor) == the simulator's host planner on the same profiled
    densities, per kernel, in the port; and the port's host planner ==
    the reference's on those densities."""
    from repro.core.perf_model import FPGACostModel as RFPGA
    b = p_gnn.build_dense("gcn", "CO", scale=0.12, seed=2, device="cpu")
    eng = p_runtime.DynasparseEngine(strategy=strategy)
    _, rep = b.run(eng)
    for k, krep in zip(b.compiled.graph.topo_order(), rep.kernels):
        codes, costs = p_analyzer.plan_kernel_host(
            strategy, krep.dens_x, krep.dens_y, k.block_dims, eng.model,
            kernel_type=k.kernel_type, device="cpu")
        hist = np.bincount(codes.reshape(-1), minlength=4)
        np.testing.assert_array_equal(hist, krep.histogram, err_msg=k.name)
        rc, rcost = r_analyzer.plan_kernel_host(
            strategy, krep.dens_x, krep.dens_y, k.block_dims, RFPGA(),
            kernel_type=r_runtime.KernelType(k.kernel_type.value))
        np.testing.assert_array_equal(codes, rc, err_msg=k.name)
        np.testing.assert_array_equal(costs, rcost, err_msg=k.name)
