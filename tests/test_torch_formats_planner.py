"""Exact integer parity of the port's profiler, formats, planner, compiler
and weights with the JAX package, on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as j_an
from repro.core import compiler as j_comp
from repro.core import formats as j_fmt
from repro.core import perf_model as j_pm
from repro.core import profiler as j_prof
from repro.core.ir import KernelType as JKT
from repro.data import graphs as j_graphs
from repro.kernels import spmm as j_spmm
from repro.models import gnn as j_gnn
from repro_torch.core import analyzer as t_an
from repro_torch.core import compiler as t_comp
from repro_torch.core import formats as t_fmt
from repro_torch.core import perf_model as t_pm
from repro_torch.core import profiler as t_prof
from repro_torch.core.ir import KernelType as TKT
from repro_torch.data import graphs as t_graphs
from repro_torch.kernels import spmm as t_spmm
from repro_torch.models import gnn as t_gnn


def sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return x * (rng.random((m, n)) < density)


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


SHAPES = [(33, 47, (16, 16)), (64, 40, (32, 16)), (5, 70, (16, 32))]


@pytest.mark.parametrize("m,n,block", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.3])
def test_profiles_exact(m, n, block, density):
    x = sparse(m * n, m, n, density)
    tc = t_prof.block_counts(torch.from_numpy(x), block)
    jc = j_prof.block_counts(jnp.asarray(x), block)
    eq(tc, jc)
    eq(t_prof.density_from_counts(tc, m, n, *block),
       j_prof.density_from_counts(jc, m, n, *block))
    tp = t_prof.BlockProfile.measure(torch.from_numpy(x), block)
    jp = j_prof.BlockProfile.measure(jnp.asarray(x), block)
    for r in (1, 2, 3):
        eq(tp.pool_rows(r).counts, jp.pool_rows(r).counts)
        eq(tp.pool_rows(r).densities(), jp.pool_rows(r).densities())
        eq(tp.pool_cols(r).counts, jp.pool_cols(r).counts)
        assert tp.pool_rows(r).block == jp.pool_rows(r).block


@pytest.mark.parametrize("m,n,block", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.3])
def test_block_formats_exact(m, n, block, density):
    x = sparse(m + n, m, n, density)
    for smax in (None, 1):
        tb = t_fmt.dense_to_bcsr(torch.from_numpy(x), block, smax)
        jb = j_fmt.dense_to_bcsr(jnp.asarray(x), block, smax)
        for a, b in ((tb.col_idx, jb.col_idx), (tb.counts, jb.counts),
                     (tb.blocks, jb.blocks)):
            eq(a, b)
        assert tb.shape == jb.shape and tb.grid == jb.grid
        tc = t_fmt.dense_to_bcsc(torch.from_numpy(x), block, smax)
        jc = j_fmt.dense_to_bcsc(jnp.asarray(x), block, smax)
        for a, b in ((tc.row_idx, jc.row_idx), (tc.counts, jc.counts),
                     (tc.blocks, jc.blocks)):
            eq(a, b)
        assert tc.shape == jc.shape
    tb = t_fmt.dense_to_bcsr(torch.from_numpy(x), block)
    np.testing.assert_array_equal(t_fmt.bcsr_to_dense(tb).numpy(), x)


@pytest.mark.parametrize("m,k", [(30, 50), (7, 16)])
@pytest.mark.parametrize("density", [0.0, 0.2])
@pytest.mark.parametrize("rmax", [0, 3, 64])
def test_ell_exact(m, k, density, rmax):
    """TRUE uncapped counts, clamped columns, rows over rmax."""
    x = sparse(m * 7 + k, m, k, density)
    te = t_fmt.dense_to_ell(torch.from_numpy(x), rmax)
    je = j_fmt.dense_to_ell(jnp.asarray(x), rmax)
    eq(te.values, je.values)
    eq(te.cols, je.cols)
    eq(te.row_counts, je.row_counts)
    assert te.shape == tuple(je.shape)
    y = sparse(5, k, 9, 0.8)
    np.testing.assert_allclose(
        t_fmt.ell_matmul(te, torch.from_numpy(y)).numpy(),
        np.asarray(j_fmt.ell_matmul(je, jnp.asarray(y))), atol=3e-4,
        rtol=3e-4)
    if rmax >= k:
        np.testing.assert_array_equal(t_fmt.ell_to_dense(te).numpy(), x)


@pytest.mark.parametrize("mk,kn", [((40, 56), (56, 24)), ((33, 70), (70, 50))])
@pytest.mark.parametrize("dx,dy", [(0.05, 0.3), (0.0, 0.5), (0.9, 0.9)])
def test_plan_intersection_exact(mk, kn, dx, dy):
    x, y = sparse(1, *mk, dx), sparse(2, *kn, dy)
    for smax in (None, 2):
        tplan = t_spmm.plan_intersection(
            t_fmt.dense_to_bcsr(torch.from_numpy(x), (16, 16)),
            t_fmt.dense_to_bcsc(torch.from_numpy(y), (16, 16)), smax)
        jplan = j_spmm.plan_intersection(
            j_fmt.dense_to_bcsr(jnp.asarray(x), (16, 16)),
            j_fmt.dense_to_bcsc(jnp.asarray(y), (16, 16)), smax)
        for a, b in zip(tplan, jplan):
            eq(a, b)


CHEAP_J = dataclasses.replace(j_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)
CHEAP_T = dataclasses.replace(t_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)
MODELS = {"fpga": (j_pm.FPGACostModel(), t_pm.FPGACostModel()),
          "tpu": (j_pm.TPUCostModel(), t_pm.TPUCostModel()),
          "cheap": (CHEAP_J, CHEAP_T)}
# the FPGA rule's thresholds (1/2, 2/p_sys) and their float32 neighbours,
# plus the reference planner's own densities count/size on 16x16 blocks
EDGES = np.array([0.0, 0.5, 0.125, np.nextafter(np.float32(0.5), 0),
                  np.nextafter(np.float32(0.125), 1), 1 / 256, 1.0,
                  0.041666668, 31 / 256, 32 / 256, 128 / 256], np.float32)


def _densities(seed, shape):
    rng = np.random.default_rng(seed)
    d = rng.choice(EDGES, size=shape).astype(np.float32)
    mix = rng.random(shape) < 0.5
    return np.where(mix, rng.integers(0, 257, shape) / np.float32(256),
                    d).astype(np.float32)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("strategy", ["dynamic", "s1", "s2", "gemm"])
@pytest.mark.parametrize("kind", ["agg", "upd"])
def test_plan_codes_exact(model, strategy, kind):
    jm, tm = MODELS[model]
    dx, dy = _densities(3, (9, 11)), _densities(4, (11, 7))
    jkt = JKT.AGGREGATE if kind == "agg" else JKT.UPDATE
    tkt = TKT.AGGREGATE if kind == "agg" else TKT.UPDATE
    # the reference planner runs compiled inside its executor
    jcodes = jax.jit(lambda a, b: j_an.plan_codes(
        strategy, a, b, jm, kernel_type=jkt))(jnp.asarray(dx),
                                              jnp.asarray(dy))
    tcodes = t_an.plan_codes(strategy, torch.from_numpy(dx),
                             torch.from_numpy(dy), tm, kernel_type=tkt)
    eq(tcodes, jcodes)
    assert tcodes.dtype == torch.int32 and tcodes.is_contiguous()


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("density", [0.002, 0.01, 0.05, 0.3])
@pytest.mark.parametrize("rmax", [0, 8, 64, 576])
def test_plan_format_exact(model, density, rmax):
    jm, tm = MODELS[model]
    m, k, d, block = 200, 200, 48, (32, 32, 16)
    x = sparse(11, m, k, density)
    dx_j = j_prof.block_density(jnp.asarray(x), block[:2])
    dx_t = t_prof.block_density(torch.from_numpy(x), block[:2])
    dy = _densities(5, (dx_t.shape[1], 3))
    for kt, jkt in ((TKT.AGGREGATE, JKT.AGGREGATE), (TKT.UPDATE, JKT.UPDATE)):
        jf = jax.jit(lambda a, b: j_an.plan_format(
            "dynamic", a, b, (m, k), d, block, jm, kernel_type=jkt,
            rmax=rmax))(dx_j, jnp.asarray(dy))
        tf = t_an.plan_format("dynamic", dx_t, torch.from_numpy(dy), (m, k),
                              d, block, tm, kernel_type=kt, rmax=rmax)
        assert (jf is None) == (tf is None)
        if tf is not None:
            assert int(tf) == int(jf)


@pytest.mark.parametrize("model", ["gcn", "sage", "gin", "sgc", "gat"])
@pytest.mark.parametrize("ds,scale", [("CO", 0.05), ("CI", 1.0),
                                      ("PU", 0.3)])
def test_compile_model_same_kernels(model, ds, scale):
    spec = j_graphs.TABLE_VI[ds]
    v = int(spec.n_vertices * scale)
    f = min(spec.f_in, max(32, int(spec.f_in * scale)))
    jspec = j_gnn.make_model_spec(model, f, spec.hidden, spec.n_classes)
    tspec = t_gnn.make_model_spec(model, f, spec.hidden, spec.n_classes)
    jc = j_comp.compile_model(jspec, j_comp.GraphMeta(ds, v, spec.n_edges, f),
                              n_cc=7, align=16, on_chip_bytes=256 * 1024)
    tc = t_comp.compile_model(tspec, t_comp.GraphMeta(ds, v, spec.n_edges, f),
                              n_cc=7, align=16, on_chip_bytes=256 * 1024)
    assert (tc.partition.n1, tc.partition.n2) == (jc.partition.n1,
                                                  jc.partition.n2)
    jk, tk = jc.graph.kernels, tc.graph.kernels
    assert [(k.name, k.lhs, k.rhs, k.out, k.epilogue_add, k.block_dims,
             int(k.kernel_type), k.agg_op.value, k.activation_enabled)
            for k in tk] == [
        (k.name, k.lhs, k.rhs, k.out, k.epilogue_add, k.block_dims,
         int(k.kernel_type), k.agg_op.value, k.activation_enabled)
        for k in jk]
    jw = j_gnn.init_spec_weights(jspec, seed=3, density=0.5)
    tw = t_gnn.init_spec_weights(tspec, seed=3, density=0.5)
    assert jw.keys() == tw.keys()
    for name in jw:
        np.testing.assert_array_equal(tw[name], jw[name])


@pytest.mark.parametrize("ds,scale", [("CO", 0.05), ("CI", 0.1)])
def test_materialize_and_weights_bitwise(ds, scale):
    jg = j_graphs.materialize(ds, scale=scale, seed=2)
    tg = t_graphs.materialize(ds, scale=scale, seed=2)
    for name in ("a", "a_gcn", "a_mean", "h0", "labels"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    assert dataclasses.astuple(tg.spec) == dataclasses.astuple(jg.spec)
    jb = j_gnn.build_dense("sage", ds, scale=scale, seed=2)
    tb = t_gnn.build_dense("sage", ds, scale=scale, seed=2, device="cpu")
    jw = j_gnn.init_weights(jb.compiled, seed=2, density=0.4)
    tw = t_gnn.init_weights(tb.compiled, seed=2, density=0.4)
    for name in jw:
        np.testing.assert_array_equal(tw[name], jw[name])
    for name, st in jb.compiled.static_stats.items():
        mine = tb.compiled.static_stats[name]
        np.testing.assert_array_equal(mine.block_densities,
                                      st.block_densities)
        assert mine.density == st.density
