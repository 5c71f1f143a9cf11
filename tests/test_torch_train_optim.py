"""The port's AdamW and checkpoints against the reference's (CPU).

AdamW runs 5 updates on the same params and seeded grads in both
packages, for float32, bfloat16 and int8 states, on trees that exercise
the reference's layout-dependent weight decay (``decay_mask``): the smoke
deepseek (``dense_first`` layers beside a scanned ``stack`` whose 1-D
norm scales carry a layer axis) and the smoke llama with
``scan_layers=False``.  Checkpoints: round trips of bf16 and int8 leaves,
``LATEST``/``gc_old``, ``save_async`` against a later in-place write,
and files written by either package read by the other's ``restore``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import model_zoo as j_zoo
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro_torch.configs import smoke_config
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tree_lib

STEPS = 5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_layout(tree):
    """A reference-layout tree in the port's per-layer layout, its leaves
    numpy float32 arrays (no cast to the port's dtypes)."""
    return model_zoo._unstack(_np(tree))


def _flat(tree):
    return [np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                       np.float32) for t in tree_lib.flatten(tree)[0]]


CASES = {
    # dense_first layers (1-D norms, not decayed) beside a scanned stack
    # (1-D norms stacked to 2-D: decayed by the reference)
    "deepseek-stacked": ("deepseek-v2-lite-16b", {"n_layers": 2, "mla": None}),
    # scan_layers=False: every per-layer 1-D leaf stays undecayed
    "llama-unrolled": ("llama3.2-1b", {"scan_layers": False}),
}


def _setup(case, param_dtype):
    arch, kw = CASES[case]
    kw = dict(kw, dtype=param_dtype)
    jcfg, tcfg = j_smoke(arch, **kw), smoke_config(arch, **kw)
    jp = j_zoo.build(jcfg).init_params(jax.random.PRNGKey(1))
    tp = model_zoo.params_from_reference(_np(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _grads(jp, seed):
    leaves, treedef = jax.tree_util.tree_flatten(jp)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.3,
                    l.dtype) for l in leaves])


def test_decay_mask_follows_the_reference_layout():
    cfg = smoke_config("deepseek-v2-lite-16b")
    mask = model_zoo.decay_mask(cfg)
    assert mask["dense_first"][0]["ln1"]["scale"] is False
    assert mask["layers"][0]["ln1"]["scale"] is True
    assert mask["final_norm"]["scale"] is False
    assert mask["embed"] is True
    unrolled = model_zoo.decay_mask(dataclasses.replace(cfg,
                                                        scan_layers=False))
    assert unrolled["layers"][0]["ln1"]["scale"] is False
    assert unrolled["layers"][0]["ffn"]["we1"] is True
    assert unrolled["dense_first"][0]["ffn"]["w1"] is True
    wcfg = smoke_config("whisper-large-v3")
    wmask = model_zoo.decay_mask(wcfg)
    assert wmask["enc_layers"][0]["ln1"]["bias"] is True
    assert wmask["enc_final"]["bias"] is False
    # the mask has the params' structure, leaf for leaf
    tree_lib.flatten_up_to(tree_lib.flatten(
        model_zoo.build(cfg, device="cpu").init_params(0))[1], mask)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("state_dtype,param_dtype,tol", [
    ("float32", "float32", 1e-6),
    ("bfloat16", "bfloat16", 0.0),
    ("int8", "bfloat16", 0.0)])
def test_adamw_matches_the_reference(case, state_dtype, param_dtype, tol):
    """5 updates with clipping, warmup and the layout's decay rule.
    Float32 (the reference jitted): within 1e-6, the global norm summing
    its leaves in another layout.  bf16 and int8 states compute in bf16,
    each scalar rounded to bf16 first as JAX's weak types are: bitwise the
    reference's update as written, op by op (eager).  Jitted, XLA keeps
    fused bf16 intermediates in float32 (excess precision): the params
    then differ from the eager reference's by up to one bf16 ulp, and
    int8 state's quantization scales by more."""
    jcfg, tcfg, jp, tp = _setup(case, param_dtype)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=1.0,
              state_dtype=state_dtype)
    jo, to = j_opt.AdamW(**kw), opt_lib.AdamW(**kw)
    js, ts = jo.init(jp), to.init(tp)
    j_update = jax.jit(jo.update) if state_dtype == "float32" else \
        jo.update
    decay = model_zoo.decay_mask(tcfg)
    tp0 = tp
    t_before = [t.clone() for t in tree_lib.flatten(tp)[0]]
    for step in range(STEPS):
        jg = _grads(jp, step)
        tg = model_zoo.params_from_reference(_np(jg), tcfg, device="cpu")
        jp, js, jn = j_update(jg, js, jp)
        tp_new, ts, tn = to.update(tg, ts, tp, decay)
        assert abs(float(jn) - float(tn)) <= 1e-5 * float(jn)
        tp = tp_new
    assert int(ts.step) == STEPS
    got, want = _flat(tp), _flat(_port_layout(jp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)
    if state_dtype == "int8":
        is_q = lambda z: isinstance(z, j_opt.Quantized)  # noqa: E731
        for part in ("q", "s"):
            jm = jax.tree.map(lambda z: getattr(z, part), js.m, is_leaf=is_q)
            tm = [getattr(z, part) for z in tree_lib.flatten_up_to(
                tree_lib.flatten(tp)[1], ts.m)]
            want = _flat(_port_layout(jm))
            for g, w in zip(tm, want):
                # per layer the reference's stacked scales are (1,) rows
                np.testing.assert_array_equal(
                    np.asarray(g.float()).reshape(w.shape), w)
    else:
        for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
            for g, w in zip(_flat(tt), _flat(_port_layout(jt))):
                np.testing.assert_allclose(g, w, atol=tol, rtol=1e-6)
    # functional: the params the first update was given are untouched
    assert all(torch.equal(a, b) for a, b in
               zip(t_before, tree_lib.flatten(tp0)[0]))


def test_adamw_decay_mask_is_what_moves_the_norms():
    """Without the mask the port would decay no 1-D leaf: the stacked
    norm scales then leave the reference's by lr * wd * |scale| a step."""
    jcfg, tcfg, jp, tp = _setup("deepseek-stacked", "float32")
    jo = j_opt.AdamW(lr=1e-1, warmup_steps=0, weight_decay=0.5)
    to = opt_lib.AdamW(lr=1e-1, warmup_steps=0, weight_decay=0.5)
    # make the norm scales nonzero in both so that decay shows
    jp = jax.tree.map(lambda a: a + 0.5, jp)
    tp = tree_lib.tree_map(lambda a: a + 0.5, tp)
    jg = _grads(jp, 9)
    tg = model_zoo.params_from_reference(_np(jg), tcfg, device="cpu")
    jp1 = jax.jit(jo.update)(jg, jo.init(jp), jp)[0]
    with_mask = to.update(tg, to.init(tp), tp, model_zoo.decay_mask(tcfg))[0]
    without = to.update(tg, to.init(tp), tp)[0]
    want = _port_layout(jp1)["layers"][0]["ln1"]["scale"]
    got = with_mask["layers"][0]["ln1"]["scale"].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(without["layers"][0]["ln1"]["scale"].numpy()
                  - want).max() > 1e-3


def test_adamw_moves_toward_minimum():
    """The reference's own case (tests/test_train_infra.py) in the port."""
    opt = opt_lib.AdamW(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0, grad_clip=1e9)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.3


@pytest.mark.parametrize("step", [0, 1, 19, 20, 21, 57, 100, 150])
def test_schedule_matches_the_reference(step):
    kw = dict(lr=3e-3, warmup_steps=20, total_steps=100)
    want = float(j_opt.AdamW(**kw).schedule(jnp.asarray(step, jnp.int32)))
    got = float(opt_lib.AdamW(**kw).schedule(torch.tensor(step,
                                                          dtype=torch.int32)))
    assert abs(got - want) <= 1e-9 + 1e-7 * abs(want)


# ----------------------------------------------------------------- trees

def test_tree_flattens_in_jax_order():
    q = opt_lib.Quantized(np.int8(1), np.float32(2.0))
    t = {"b": [1, (2, 3)], "a": {"z": 4, "y": q}, "c": None}
    leaves, treedef = tree_lib.flatten(t)
    assert leaves == jax.tree.leaves(t) == [1, 2.0, 4, 1, 2, 3]
    back = tree_lib.unflatten(treedef, leaves)
    assert back["a"]["y"] == q and isinstance(back["a"]["y"],
                                              opt_lib.Quantized)
    assert back["b"][1] == (2, 3) and back["c"] is None


# ------------------------------------------------------------ checkpoints

def _mixed_tree(seed):
    """bf16, int8, float32, int32 and a Quantized leaf, nested in dicts,
    lists and NamedTuples, as numpy arrays (reference) and tensors."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    i8 = rng.integers(-127, 128, size=(7,)).astype(np.int8)
    s = rng.random((2, 1)).astype(np.float32)
    q = rng.integers(-127, 128, size=(2, 3)).astype(np.int8)
    step = np.asarray(seed, np.int32)
    jt = opt_lib.AdamWState(
        jnp.asarray(step),
        {"w": jnp.asarray(b, jnp.bfloat16), "f": [jnp.asarray(f),
                                                  jnp.asarray(i8)]},
        {"w": j_opt.Quantized(jnp.asarray(q), jnp.asarray(s)),
         "f": [jnp.asarray(f), jnp.asarray(i8)]})
    tt = opt_lib.AdamWState(
        torch.from_numpy(step),
        {"w": torch.from_numpy(b).to(torch.bfloat16),
         "f": [torch.from_numpy(f), torch.from_numpy(i8)]},
        {"w": opt_lib.Quantized(torch.from_numpy(q), torch.from_numpy(s)),
         "f": [torch.from_numpy(f), torch.from_numpy(i8)]})
    return jt, tt


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _assert_same_bits(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_bf16_and_int8(tmp_path):
    _, tt = _mixed_tree(3)
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tt)
    got, at = ckpt.restore(d, tt)
    assert at == 1 and isinstance(got, opt_lib.AdamWState)
    assert isinstance(got.v["w"], opt_lib.Quantized)
    assert got.m["w"].dtype == torch.bfloat16
    _assert_same_bits(tree_lib.flatten(got)[0], tree_lib.flatten(tt)[0])
    manifest = json.loads((tmp_path / "ck" / "step_00000001" /
                           "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "int32", "float32", "int8", "bfloat16", "float32", "int8", "int8",
        "float32"]
    assert np.load(tmp_path / "ck" / "step_00000001" /
                   "leaf-000003.npy").dtype == np.uint16


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_files_cross_read(tmp_path, writer):
    """The same nesting writes the same leaf files in both packages: each
    package's restore reads the other's, bitwise."""
    jt, tt = _mixed_tree(5)
    d = str(tmp_path / "ck")
    if writer == "port":
        ckpt.save(d, 4, tt)
        got, at = j_ckpt.restore(d, jt)
        _assert_same_bits(jax.tree.leaves(got), tree_lib.flatten(tt)[0])
    else:
        j_ckpt.save(d, 4, jt)
        got, at = ckpt.restore(d, tt)
        _assert_same_bits(tree_lib.flatten(got)[0], jax.tree.leaves(jt))
    assert at == 4
    other = str(tmp_path / "other")
    (j_ckpt.save if writer == "port" else ckpt.save)(other, 4,
                                                     jt if writer == "port"
                                                     else tt)
    for name in sorted(os.listdir(os.path.join(d, "step_00000004"))):
        if name.endswith(".npy"):
            a = np.load(os.path.join(d, "step_00000004", name))
            b = np.load(os.path.join(other, "step_00000004", name))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(4)}
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, tree)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree)
    assert ckpt.latest_step(d) == 4
    ckpt.gc_old(d, keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004"]
    with pytest.raises(ValueError, match="architecture mismatch"):
        ckpt.restore(d, {"x": torch.arange(4), "y": torch.arange(2)})


def test_save_async_snapshots_before_a_later_step(tmp_path):
    """save_async copies every leaf before it returns: an in-place write
    to the live tensor right after (the next step) does not reach the
    file, though on the CPU ``.cpu()`` would share the storage."""
    d = str(tmp_path / "ck")
    live = {"x": torch.ones((256, 256)), "b": torch.ones(8,
                                                         dtype=torch.bfloat16)}
    ckpt.save_async(d, 7, live)
    live["x"].mul_(3.0)
    live["b"].add_(1.0)
    ckpt.wait()
    got, s = ckpt.restore(d, live)
    assert s == 7 and float(got["x"].sum()) == 256 * 256
    assert got["b"].dtype == torch.bfloat16 and float(got["b"].sum()) == 8
