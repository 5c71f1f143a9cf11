"""GAT in the port against the JAX package, on the CPU.

The counterpart of ``tests/test_gat_attention.py``: the masked
edge-softmax (``attention_adjacency``) on seeded numpy inputs, per-head
attention densities and the plans they drive, the executor signature,
the weights and the ``infer`` entry point.  Alpha is held within 3e-4
(``tests/test_kernels.py:39``); its support, block counts, densities and
every code exactly, with a report of the entries one side zeroed and the
other kept (none is expected here; each must lie within 1e-6 of the
threshold).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiler as j_comp
from repro.core import runtime as j_rt
from repro.core.dynasparse import attention_adjacency as j_attention
from repro.data import graphs as j_graphs
from repro.models import gnn as j_gnn
from repro_torch import infer
from repro_torch.core import compiler as t_comp
from repro_torch.core import runtime as t_rt
from repro_torch.core.dynasparse import attention_adjacency as t_attention
from repro_torch.core.perf_model import Primitive
from repro_torch.kernels import edge_softmax as t_edge
from repro_torch.kernels import ops
from repro_torch.models import gnn as t_gnn

ALPHA_TOL = dict(atol=3e-4, rtol=3e-4)
FLIP_DIST = 1e-6      # a support flip further than this from the threshold
PAD_ROWS = 5          # all-zero (bucket-padding) rows at the end of ``a``


def operands(n, f, seed=0, empty=False):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.2).astype(np.float32)
    a[-PAD_ROWS:] = 0.0
    if empty:
        a[:] = 0.0
    return (a, rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=(f, 1)).astype(np.float32),
            rng.normal(size=(f, 1)).astype(np.float32))


def both(args, **kw):
    j = j_attention(*map(jnp.asarray, args), **kw)
    t = t_attention(*map(torch.from_numpy, args), **kw)
    return j, t


def assert_same_result(j, t, threshold):
    """Alpha within 3e-4; every integer side output exactly."""
    ja = np.asarray(j.out)
    flips, dist = t_edge.support_flips(t.out, torch.from_numpy(ja.copy()),
                                       threshold)
    assert dist <= FLIP_DIST, (flips, dist)
    assert flips == 0, f"{flips} support flips, all within {dist}"
    np.testing.assert_allclose(t.out.numpy(), ja, **ALPHA_TOL)
    assert t.out.dtype == torch.float32
    for name in ("out_counts", "out_density", "codes", "dens_x", "dens_y",
                 "fmt"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("out_block", [(16, 16), (32, 16)])
@pytest.mark.parametrize("slope", [0.2, 0.0])
@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.6])
@pytest.mark.parametrize("f", [6, 8])
@pytest.mark.parametrize("n", [40, 37])
def test_attention_adjacency_matches_reference(n, f, threshold, slope,
                                               out_block):
    args = operands(n, f, seed=n * f)
    kw = dict(slope=slope, threshold=threshold, out_block=out_block)
    j, t = both(args, **kw)
    assert_same_result(j, t, threshold)
    alpha = t.out.numpy()
    assert (alpha[args[0] == 0] == 0.0).all()
    assert (alpha[-PAD_ROWS:] == 0.0).all()         # padding: exactly zero
    if threshold == 0.0:
        live = args[0].sum(axis=1) > 0
        np.testing.assert_allclose(alpha[live].sum(axis=1), 1.0, atol=1e-5)
    assert int(t.codes.reshape(-1)[0]) == int(Primitive.GEMM)


@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.6])
def test_attention_adjacency_all_zero_adjacency(threshold):
    args = operands(37, 6, seed=1, empty=True)
    j, t = both(args, threshold=threshold, out_block=(16, 16))
    assert_same_result(j, t, threshold)
    assert not t.out.any() and not t.out_counts.any()
    assert not torch.isnan(t.out).any()


def test_attention_threshold_drops_to_exact_zero():
    a, z, asrc, adst = operands(32, 6, seed=3)
    a[:] = (np.random.default_rng(1).random((32, 32)) < 0.5)
    free = t_attention(*map(torch.from_numpy, (a, z, asrc, adst)),
                       threshold=0.0, out_block=(16, 16)).out
    cut = t_attention(*map(torch.from_numpy, (a, z, asrc, adst)),
                      threshold=0.05, out_block=(16, 16)).out
    kept = cut != 0
    assert int(kept.sum()) < int((free != 0).sum())
    assert torch.equal(cut[kept], free[kept])
    assert bool((free[kept] > 0.05).all())


def test_ops_edge_softmax_on_cpu_is_the_plain_version():
    a, z, asrc, adst = map(torch.from_numpy, operands(40, 8, seed=4))
    before = t_edge.launches
    got, got_counts = ops.edge_softmax(a.T, z, asrc, adst, threshold=0.02,
                                       out_block=(16, 16))
    want, want_counts = t_edge.edge_softmax_plain(
        a.T.contiguous(), z, asrc, adst, threshold=0.02, out_block=(16, 16))
    assert torch.equal(got, want)
    assert torch.equal(got_counts, want_counts)
    assert t_edge.launches == before


DTYPE_CASES = {"f32": (np.float32, np.float32), "bf16 a": ("bf16", None),
               "bf16 z": (None, "bf16"), "bf16 a and z": ("bf16", "bf16")}


def cast_operands(args, case):
    """The operands in both packages, ``a`` and/or ``z`` (and the
    attention vectors with ``z``) rounded to bf16 from the same float32
    values."""
    a_t, z_t = DTYPE_CASES[case]
    jx = [jnp.asarray(v) for v in args]
    tx = [torch.from_numpy(v) for v in args]
    for idx in ([0] if a_t == "bf16" else []) + ([1, 2, 3] if z_t == "bf16"
                                                 else []):
        jx[idx] = jx[idx].astype(jnp.bfloat16)
        tx[idx] = tx[idx].bfloat16()
    return jx, tx


@pytest.mark.parametrize("case", list(DTYPE_CASES))
@pytest.mark.parametrize("out_block", [(16, 16), (32, 16), (128, 128),
                                       (16, 48)])
@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.6])
@pytest.mark.parametrize("n", [40, 37])
def test_plain_alpha_and_counts_match_reference(n, threshold, out_block,
                                                case):
    """The plain ``(alpha, counts)`` against the reference's
    ``attention_adjacency`` (``out``, ``out_counts``): counts exactly,
    alpha within 3e-4 in the promoted type, for float32 and bf16
    ``a``/``z``."""
    args = operands(n, 8, seed=7 * n + 1)
    rng = np.random.default_rng(n)
    args = (args[0] * rng.random(args[0].shape).astype(np.float32),
            *args[1:])                      # a normalized-looking support
    jx, tx = cast_operands(args, case)
    kw = dict(slope=0.2, threshold=threshold, out_block=out_block)
    j = j_attention(*jx, **kw)
    alpha, counts = t_edge.edge_softmax_plain(*tx, **kw)
    want = np.asarray(j.out.astype(jnp.float32))
    flips, dist = t_edge.support_flips(alpha.float(),
                                       torch.from_numpy(want.copy()), threshold)
    assert flips == 0, f"{flips} support flips, all within {dist}"
    assert alpha.dtype == torch.promote_types(tx[0].dtype, tx[1].dtype)
    assert str(alpha.dtype).split(".")[-1] == str(j.out.dtype)
    np.testing.assert_allclose(alpha.float().numpy(), want, **ALPHA_TOL)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j.out_counts))
    assert counts.shape == (-(-n // out_block[0]), -(-n // out_block[1]))


def test_attention_adjacency_takes_the_counts_from_the_edge_softmax(
        monkeypatch):
    """No ``profiler.block_counts`` of alpha beside the edge-softmax's
    own counting (its plain version's one ``tile_nnz_plain``)."""
    from repro_torch.core import dynasparse as t_dyn
    from repro_torch.core import profiler as t_prof
    calls = {"block_counts": 0, "tile_nnz_plain": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(t_prof, "block_counts",
                        counted("block_counts", t_prof.block_counts))
    monkeypatch.setattr(t_edge, "tile_nnz_plain",
                        counted("tile_nnz_plain", t_edge.tile_nnz_plain))
    args = operands(40, 8, seed=5)
    res = t_dyn.attention_adjacency(*map(torch.from_numpy, args),
                                    threshold=0.05, out_block=(16, 16))
    assert calls == {"block_counts": 0, "tile_nnz_plain": 1}
    j = j_attention(*map(jnp.asarray, args), threshold=0.05,
                    out_block=(16, 16))
    np.testing.assert_array_equal(res.out_counts.numpy(),
                                  np.asarray(j.out_counts))


@pytest.mark.parametrize("n,route", [(1, "list"), (3327, "list"),
                                     (8192, "list"), (8193, "list"),
                                     (9000, "list"), (19717, "list"),
                                     (32768, "list"), (32769, "reread"),
                                     (40000, "reread"), (232965, "reread")])
@pytest.mark.parametrize("out_block", [(16, 16), (32, 16), (128, 128),
                                       (16, 48), (1, 1)])
def test_edge_launch_shape(n, route, out_block):
    """Each tile row's rows are covered once, by warps of CTAs that stay
    inside it; shared memory holds what the shape says and fits the H100;
    the counts start from zero exactly when several CTAs share a tile
    row or the counters do not fit."""
    s = t_edge.edge_launch(n, out_block)
    bm, bn = out_block
    assert t_edge.ROUTES[s.route] == route
    assert 1 <= s.rows <= t_edge.MAX_ROWS and s.rows <= bm
    assert (s.chunks - 1) * s.rows < bm <= s.chunks * s.rows
    covered = np.zeros(n, dtype=np.int64)
    for b in range(-(-n // bm) * s.chunks):     # the kernel's grid
        ti, ch = divmod(b, s.chunks)
        r0 = ti * bm + ch * s.rows
        rows = np.arange(r0, min(r0 + s.rows, (ti + 1) * bm, n))
        assert ((rows // bm) == ti).all()
        covered[rows] += 1
    assert (covered == 1).all()
    nb = -(-n // bn)
    assert s.stage_dst == (n <= t_edge.STAGE_COLS)
    assert s.smem_counts == (nb <= t_edge.COUNT_TILES)
    lists = s.rows * (8 * -(-n // 32) + 16) if route == "list" else 0
    assert s.smem_bytes == (lists + 4 * n * s.stage_dst
                            + 4 * nb * s.smem_counts)
    assert s.smem_bytes <= 227 * 1024
    assert s.zero_counts == (s.chunks > 1 or not s.smem_counts)


@pytest.mark.parametrize("shapes", [((4, 5), (4, 3), (3, 1), (3, 1)),
                                    ((4, 4), (5, 3), (3, 1), (3, 1)),
                                    ((4, 4), (4, 3), (3,), (3, 1)),
                                    ((4, 4), (4, 3), (3, 1), (2, 1))])
def test_edge_softmax_refuses_bad_shapes(shapes):
    with pytest.raises(ValueError):
        t_edge.check_shapes(*(torch.zeros(s) for s in shapes))


def test_support_flips_reports_count_and_distance():
    want = torch.tensor([[0.0, 0.5, 0.0200001], [0.3, 0.0, 0.0]])
    got = torch.tensor([[0.0, 0.5, 0.0], [0.3, 0.0, 0.01999995]])
    n, dist = t_edge.support_flips(got, want, 0.02)
    assert n == 2 and dist == pytest.approx(1e-7, abs=2e-8)
    assert t_edge.support_flips(want, want, 0.02) == (0, 0.0)


# -- GAT bundles: the reference's, carried into the port ----------------------

def gat_bundles(threshold=0.02, heads=2, seed=2):
    """The reference test's CO/0.12 GAT bundle in both packages, the port
    on the reference's arrays."""
    g = j_graphs.materialize("CO", scale=0.12, seed=seed)
    out = []
    for comp, gnn in ((j_comp, j_gnn), (t_comp, t_gnn)):
        spec = comp.GNNModelSpec(
            "gat", [g.spec.f_in, g.spec.hidden, g.spec.n_classes],
            gat_heads=heads, att_threshold=threshold)
        meta = comp.GraphMeta("CO", g.spec.n_vertices, g.spec.n_edges,
                              g.spec.f_in)
        arrays = {"A": g.a_gcn, "A_mean": g.a_mean, "H0": g.h0}
        tensors = ({k: jnp.asarray(v) for k, v in arrays.items()}
                   if comp is j_comp else
                   t_gnn.tensors_from_reference(arrays, "cpu"))
        cm = comp.compile_model(spec, meta, n_cc=7, tensors=tensors,
                                align=16, on_chip_bytes=256 * 1024)
        weights = gnn.init_weights(cm, seed=seed)
        tensors.update({k: jnp.asarray(v) for k, v in weights.items()}
                       if comp is j_comp else
                       t_gnn.tensors_from_reference(weights, "cpu"))
        out.append((cm, tensors))
    return out


def test_per_head_attention_densities_differ_as_in_reference():
    (jc, jt), (tc, tt) = gat_bundles()
    j_f = j_rt.FusedModelExecutor(keep_codes=True, keep_intermediates=True)
    t_f = t_rt.FusedModelExecutor(keep_codes=True, keep_intermediates=True)
    j_env, _ = j_f.run(jc, jt)
    t_env, _ = t_f.run(tc, tt)
    for name in ("T1h1", "T1h2", "T2h1", "T2h2"):
        assert_support_equal(t_env[name], j_env[name], 0.02)
        np.testing.assert_array_equal(
            t_f.profiled_densities[name].numpy(),
            np.asarray(j_f.profiled_densities[name]), err_msg=name)
    d1, d2 = (t_f.profiled_densities[n].numpy() for n in ("T1h1", "T1h2"))
    assert not np.array_equal(d1, d2)
    for name, codes in j_f.planned_codes.items():
        np.testing.assert_array_equal(t_f.planned_codes[name], codes,
                                      err_msg=name)
    assert not np.array_equal(t_f.planned_codes["G1h1"],
                              t_f.planned_codes["H1"])


def assert_support_equal(got, want, threshold):
    flips, dist = t_edge.support_flips(got, torch.from_numpy(
        np.array(want)), threshold)
    assert flips == 0 and dist == 0.0, (flips, dist)


def test_attention_sparsity_drives_the_plan_as_in_reference():
    codes, nnz = {}, {}
    for threshold in (0.0, 0.6):
        (jc, jt), (tc, tt) = gat_bundles(threshold=threshold, heads=1)
        j_eng = j_rt.DynasparseEngine(keep_codes=True)
        t_eng = t_rt.DynasparseEngine(keep_codes=True)
        j_env, _ = j_eng.run(jc, jt)
        t_env, _ = t_eng.run(tc, tt)
        assert_support_equal(t_env["T1h1"], j_env["T1h1"], threshold)
        for name, c in j_eng.planned_codes.items():
            np.testing.assert_array_equal(t_eng.planned_codes[name], c,
                                          err_msg=name)
        codes[threshold] = t_eng.planned_codes["H1"]
        nnz[threshold] = int((t_env["T1h1"] != 0).sum())
    assert nnz[0.6] < nnz[0.0]
    assert not np.array_equal(codes[0.6], codes[0.0])
    skips = {t: int((c == int(Primitive.SKIP)).sum())
             for t, c in codes.items()}
    assert skips[0.6] >= skips[0.0]


def test_gat_spec_knobs_change_signature():
    """A port counterpart of the reference's test of the same name: specs
    that differ only in the attention threshold must not share a walk
    plan."""
    (_, _), (cm_a, _) = gat_bundles(threshold=0.02)
    (_, _), (cm_b, _) = gat_bundles(threshold=0.3)
    assert all(k.att_threshold == 0.02 for k in cm_a.graph.kernels
               if k.att_src is not None)
    sig_a = t_rt.FusedModelExecutor()._signature(cm_a, {})
    sig_b = t_rt.FusedModelExecutor()._signature(cm_b, {})
    assert sig_a != sig_b
    cm_c = dataclasses.replace(cm_a, graph=dataclasses.replace(
        cm_a.graph, kernels=[dataclasses.replace(k, att_slope=0.1)
                             for k in cm_a.graph.kernels]))
    assert t_rt.FusedModelExecutor()._signature(cm_c, {}) != sig_a


def test_fused_walk_plans_once_per_threshold():
    (_, _), (cm_a, tensors) = gat_bundles(threshold=0.02)
    (_, _), (cm_b, _) = gat_bundles(threshold=0.3)
    fused = t_rt.FusedModelExecutor(keep_intermediates=True)
    env_a, _ = fused.run(cm_a, tensors)
    env_b, _ = fused.run(cm_b, tensors)
    fused.run(cm_a, tensors)
    assert fused.trace_count == 2 and fused.cache_hits == 1
    assert int((env_b["T1h1"] != 0).sum()) < int((env_a["T1h1"] != 0)
                                                 .sum())


def test_each_attention_kernel_is_one_gemm_step():
    (_, _), (tc, tt) = gat_bundles()
    eng = t_rt.DynasparseEngine(keep_codes=True)
    _, rep = eng.run(tc, tt)
    att = [r for k, r in zip(tc.graph.kernels, rep.kernels)
           if k.att_src is not None]
    assert len(att) == 4
    for r in att:
        np.testing.assert_array_equal(r.histogram, [0, 1, 0, 0])
        assert r.num_tasks == 1
    assert all(int(eng.planned_formats[k.out]) == 0
               for k in tc.graph.kernels if k.att_src is not None)


@pytest.mark.parametrize("seed,density", [(0, 1.0), (2, 0.5)])
def test_gat_init_weights_equal_reference(seed, density):
    (jc, _), (tc, _) = gat_bundles(seed=seed)
    jw = j_gnn.init_weights(jc, seed=seed, density=density)
    tw = t_gnn.init_weights(tc, seed=seed, density=density)
    assert list(tw) == list(jw)
    assert {f"a_src{l}h{h}" for l in (1, 2) for h in (1, 2)} <= set(tw)
    for name in jw:
        assert tw[name].dtype == jw[name].dtype
        np.testing.assert_array_equal(tw[name], jw[name], err_msg=name)


def test_build_dense_gat_carries_the_reference_bundle():
    jb = j_gnn.build_dense("gat", "CO", scale=0.05, seed=1)
    tb = t_gnn.build_dense("gat", "CO", scale=0.05, seed=1, device="cpu")
    assert "gat" in t_gnn.GNN_MODELS
    assert tb.tensors.keys() == jb.tensors.keys()
    carried = t_gnn.tensors_from_reference(
        {k: np.asarray(v) for k, v in jb.tensors.items()}, "cpu")
    for name, t in carried.items():
        assert torch.equal(t, tb.tensors[name]), name


def test_infer_runs_gat_on_the_cpu(capsys):
    infer.main(["--model", "gat", "--device", "cpu", "--ds", "CO",
                "--scale", "0.1"])
    out = capsys.readouterr().out
    assert "== GAT on CO" in out
    for strategy in ("gemm", "s1", "s2", "dynamic"):
        assert f"{strategy:8s} hist[SKIP,GEMM,SPDMM,SPMM]=" in out
    assert "wall=" in out and "bitwise==per-kernel: True" in out


def test_infer_without_a_card_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--model", "gat", "--ds", "CO", "--scale", "0.1"])
