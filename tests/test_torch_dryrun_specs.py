"""The dry run's meshes, sharding rules, abstract trees and logical-axis
context (``repro_torch.launch.mesh``, the LM rules of
``repro_torch.distributed.sharding``, ``model_zoo.{input_specs,
abstract_params, abstract_caches}``, ``repro_torch.distributed.shardctx``)
against the JAX package's.

The reference's rules run in-process on ``AbstractMesh``es with Auto axes
(no devices); its production meshes are built once, in a subprocess with
512 forced host devices, where nothing is compiled.  Every spec is
compared as a tuple, leaf by leaf with the leaf's path.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.configs.registry import cell_supported as j_cell_supported
from repro.distributed import shardctx as j_shardctx
from repro.distributed import sharding as j_sharding
from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import model_zoo as j_zoo
from repro.models import transformer as j_transformer
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs.registry import cell_supported
from repro_torch.distributed import sharding, shardctx
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import attention, model_zoo, transformer
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW

from torch_lm_pairs import pair, rnd, tokens, t2np

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCH_NAMES = sorted(ARCHS)


def j_mesh(sizes, names):
    return AbstractMesh(tuple(sizes), tuple(names),
                        axis_types=(AxisType.Auto,) * len(sizes))


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def j_specs(shardings):
    return [(tuple(_key(k) for k in path), tuple(s.spec))
            for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]]


def p_specs(shardings):
    return [(path, tuple(s.spec))
            for path, s in tree_lib.flatten_with_path(shardings)]


@functools.lru_cache(maxsize=None)
def j_params(arch, scan):
    return j_zoo.abstract_params(
        dataclasses.replace(j_get_arch(arch), scan_layers=scan))


@functools.lru_cache(maxsize=None)
def p_params(arch):
    return model_zoo.abstract_params(get_arch(arch))


def _dtype(d):
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else str(np.dtype(d))


def shapes_of(tree, port):
    if port:
        return [(p, tuple(x.shape), _dtype(x.dtype))
                for p, x in tree_lib.flatten_with_path(tree)]
    return [(tuple(_key(k) for k in p), tuple(x.shape), _dtype(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# --------------------------------------------------------------------------
# 1. launch/mesh.py
# --------------------------------------------------------------------------

REF_MESHES = """
    import json
    from repro.launch import mesh
    out = {}
    for name, m in (("single", mesh.make_production_mesh()),
                    ("multi_pod", mesh.make_production_mesh(multi_pod=True)),
                    ("test", mesh.make_test_mesh(8, 4))):
        out[name] = [list(m.axis_names), list(m.shape.items()), m.size]
    print(json.dumps(out))
"""


def test_meshes_equal_the_reference_production_and_test_meshes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_MESHES)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {"single": port_mesh.make_production_mesh(),
           "multi_pod": port_mesh.make_production_mesh(multi_pod=True),
           "test": port_mesh.make_test_mesh(8, 4)}
    for name, m in got.items():
        assert [list(m.axis_names), [list(kv) for kv in m.shape.items()],
                m.size] == want[name], name
    assert want["single"][2] == 256 and want["multi_pod"][2] == 512


# --------------------------------------------------------------------------
# 2. the LM rules
# --------------------------------------------------------------------------

def _eps(arch):
    """Expert parallelism off and on; on changes nothing where there is
    no expert leaf."""
    return (False, True) if get_arch(arch).moe is not None else (False,)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_rule_gives_every_reference_leaf_its_spec(arch):
    """(a) The port's rule fed the reference's own trees (both scan modes,
    with and without expert parallelism) on both production meshes and
    the test mesh: every spec equal."""
    for scan in (True, False):
        tree = j_params(arch, scan)
        for sizes, names in MESHES.values():
            for ep in _eps(arch):
                want = j_specs(j_sharding.param_shardings(
                    j_mesh(sizes, names), tree, ep_experts=ep))
                got = p_specs(sharding.param_shardings(
                    sharding.NamedMesh(sizes, names), tree, ep_experts=ep))
                assert got == want, (arch, scan, names, ep)


def test_param_rule_skips_the_quantized_moment_fields():
    """An int8 optimizer state's moments are ``Quantized(q, s)``: the rule
    looks past the field names to the param's (row-parallel w2 etc.)."""
    tree = j_params("llama3.2-1b", False)
    m = jax.eval_shape(JAdamW(state_dtype="int8").init, tree).m
    sizes, names = MESHES["16x16"]
    want = j_specs(j_sharding.param_shardings(j_mesh(sizes, names), m))
    got = p_specs(sharding.param_shardings(sharding.NamedMesh(sizes, names),
                                           m))
    assert got == want
    assert any(p[-2:] == ("w2", "q") and s == ("model", "data")
               for p, s in got)
    # the port's own int8 state has the same paths and specs
    pm = AdamW(state_dtype="int8").init(p_params("llama3.2-1b")).m
    assert p_specs(sharding.param_shardings(
        sharding.NamedMesh(sizes, names), pm)) == want


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_trees_equal_the_reference_leaf_for_leaf(arch):
    """(b) The port's param_shardings on its own (per-layer) layout equals
    the reference's unrolled layout (scan_layers=False) leaf for leaf;
    against the scanned layout, every stacked spec minus its layer dim
    equals the port's per layer, except where stacking made a 1-D leaf
    2-D (norm scales, biases: counted by the test below)."""
    for sizes, names in MESHES.values():
        for ep in _eps(arch):
            got = p_specs(sharding.param_shardings(
                sharding.NamedMesh(sizes, names), p_params(arch),
                ep_experts=ep))
            want = j_specs(j_sharding.param_shardings(
                j_mesh(sizes, names), j_params(arch, False), ep_experts=ep))
            assert got == want, (arch, names, ep)
            port = dict(got)
            for path, spec, rank in _stacked_specs(arch, sizes, names, ep):
                for layer_path in _port_paths(arch, path):
                    if rank == 1:
                        assert port[layer_path] == ()
                    else:
                        assert port[layer_path] == spec[1:], (layer_path,
                                                              spec)


def _stacked_specs(arch, sizes, names, ep):
    """(path, spec, per-layer rank) of every leaf of the reference's
    stacked regions."""
    tree = j_params(arch, True)
    want = j_sharding.param_shardings(j_mesh(sizes, names), tree,
                                      ep_experts=ep)
    ranks = {tuple(_key(k) for k in p): len(x.shape) - 1
             for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return [(p, s, ranks[p]) for p, s in j_specs(want)
            if p[0] in ("stack", "enc_stack", "dec_stack")]


def _port_paths(arch, path):
    """The port's per-layer paths of a reference stacked path (the key map
    of ``model_zoo._unstack``)."""
    cfg = get_arch(arch)
    if path[0] == "stack":
        period, j = cfg.layer_period, path[1]
        return [("layers", j + period * i) + path[2:]
                for i in range(cfg.n_periods)]
    key = {"enc_stack": "enc_layers", "dec_stack": "dec_layers"}[path[0]]
    n = (cfg.encdec.n_enc_layers if key == "enc_layers" else cfg.n_layers)
    return [(key, i) + path[1:] for i in range(n)]


def test_stacked_1d_leaves_are_the_only_specs_without_a_counterpart():
    """Under scan_layers=True the reference shards the 2-D stacks of 1-D
    leaves (a (n_periods, d) norm scale takes ("data", "model") on the
    16x16 mesh when n_periods divides 16); the port's per-layer 1-D
    leaves replicate.  Count them per arch on the 16x16 mesh."""
    sizes, names = MESHES["16x16"]
    counts = {}
    for arch in ARCH_NAMES:
        counts[arch] = sum(1 for _, spec, rank in _stacked_specs(
            arch, sizes, names, False) if rank == 1 and any(spec))
    print("stacked 1-D leaves sharded by the reference:", counts)
    assert counts["llama3.2-1b"] == 2      # ln1, ln2 scales over 16 periods
    assert counts["grok-1-314b"] == 2


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name, scan):
    cfg = dataclasses.replace(j_get_arch(arch), scan_layers=scan)
    return j_zoo.abstract_caches(cfg, J_SHAPES[shape_name])


# the cells the registry allows (the port's copy; held equal to the
# reference's below)
CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES if cell_supported(a, s)]


def test_cell_supported_equals_the_reference():
    assert {(a, s): cell_supported(a, s) for a in ARCH_NAMES
            for s in SHAPES} == {(a, s): j_cell_supported(a, s)
                                 for a in ARCH_NAMES for s in SHAPES}
    assert len(CELLS) == 32


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cache_and_batch_specs_equal_the_reference(arch, shape_name):
    """(c) cache_shardings and batch_shardings: the rule on the
    reference's stacked caches, and the port's own trees against the
    reference's unrolled ones, on the three meshes."""
    shape = SHAPES[shape_name]
    b = shape.global_batch
    j_batch = j_zoo.input_specs(j_get_arch(arch), J_SHAPES[shape_name])
    p_batch = model_zoo.input_specs(get_arch(arch), shape)
    for sizes, names in MESHES.values():
        jm, pm = j_mesh(sizes, names), sharding.NamedMesh(sizes, names)
        for scan in (True, False):
            tree = _caches(arch, shape_name, scan)
            assert p_specs(sharding.cache_shardings(pm, tree, b)) == \
                j_specs(j_sharding.cache_shardings(jm, tree, b))
        want = j_specs(j_sharding.cache_shardings(
            jm, _caches(arch, shape_name, False), b))
        got = p_specs(sharding.cache_shardings(
            pm, model_zoo.abstract_caches(get_arch(arch), shape), b))
        assert got == want
        assert p_specs(sharding.batch_shardings(pm, p_batch, b)) == \
            j_specs(j_sharding.batch_shardings(jm, j_batch, b))


def test_rules_on_small_meshes_and_describe():
    """The reference test's mock-mesh rules (tests/test_distributed.py),
    the replicated spec and describe's ``path: spec`` lines."""
    m = sharding.NamedMesh((4, 8), ("data", "model"))
    assert sharding.param_spec(m, (12, 16)) == ("data", "model")
    assert sharding.param_spec(m, (13, 15)) == (None, None)
    assert sharding.param_spec(m, (27, 12, 16)) == (None, "data", "model")
    assert sharding.param_spec(m, (16,)) == ()
    m3 = sharding.NamedMesh((2, 4, 8), ("pod", "data", "model"))
    spec = sharding.cache_spec(m3, (16, 64, 4096, 2, 64), batch=64)
    assert spec[1] == ("pod", "data") and spec[4] == "model"
    assert spec[2] is None
    spec = sharding.cache_spec(m3, (16, 1, 524288, 2, 64), batch=1)
    assert spec[1] is None and spec[4] == "model"
    assert sharding.cache_spec(m3, (16, 64, 4096, 2, 63), batch=64)[2] == \
        "model"
    assert sharding.replicated(m).spec == ()
    sh = sharding.param_shardings(m, {"a": {"w2": torch.empty(16, 8)},
                                      "b": [torch.empty(3)]})
    assert sharding.describe(sh) == ("['a']['w2']: PartitionSpec('model', "
                                     "'data')\n['b'][0]: PartitionSpec()")
    assert sharding.describe(sh, max_lines=1).count("\n") == 0
    assert sharding.shard_bytes(torch.empty(16, 8), sh["a"]["w2"]) == \
        16 * 8 * 4 / 32


# --------------------------------------------------------------------------
# 3. abstract trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_params_equal_the_reference_eval_shape(arch):
    """Shapes and dtypes of every param leaf, against the reference's
    ``jax.eval_shape`` in both layouts (the scanned one through the key
    map ``params_from_reference`` uses, on zero-stride arrays)."""
    from repro_torch.models.model_zoo import _unstack
    got = shapes_of(p_params(arch), port=True)
    assert got == shapes_of(j_params(arch, False), port=False)
    stacked = jax.tree.map(
        lambda x: np.broadcast_to(np.zeros((), x.dtype), x.shape),
        j_params(arch, True))
    assert got == shapes_of(_unstack(stacked), port=True)
    assert all(x.device.type == "meta" for x in
               tree_lib.flatten(p_params(arch))[0])


@pytest.mark.parametrize("arch,shape_name",
                         [(a, s) for a in ARCH_NAMES for s in SHAPES])
def test_input_specs_and_caches_equal_the_reference_eval_shape(
        arch, shape_name):
    """Every input (whisper's frames and its dec_ratio decoder length
    included) and every cache leaf of the cell."""
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    jshape, shape = J_SHAPES[shape_name], SHAPES[shape_name]
    assert shapes_of(model_zoo.input_specs(cfg, shape), port=True) == \
        shapes_of(j_zoo.input_specs(jcfg, jshape), port=False)
    got = model_zoo.abstract_caches(cfg, shape)
    assert shapes_of(got, port=True) == \
        shapes_of(_caches(arch, shape_name, False), port=False)
    assert all(x.device.type == "meta" for x in tree_lib.flatten(got)[0])


# --------------------------------------------------------------------------
# 4. shardctx: axis sizes and the attention branch
# --------------------------------------------------------------------------

LOGICAL = ("batch", "model", "seq", "data", "expert", "other")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_axis_size_equals_the_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    want, got = {}, {}
    with j_shardctx.use_mesh(j_mesh(sizes, names)):
        want = {a: j_shardctx.axis_size(a) for a in LOGICAL}
    with shardctx.use_mesh(sharding.NamedMesh(sizes, names)):
        got = {a: shardctx.axis_size(a) for a in LOGICAL}
    assert got == want
    assert shardctx.axis_size("model") == j_shardctx.axis_size("model") == 1
    x = torch.ones(3)
    assert shardctx.shard(x, "batch") is x


def _identity_shard(monkeypatch):
    """The reference's model modules with ``shard`` the identity (no
    partitioner in a single-device test)."""
    for mod in (j_attention, j_layers, j_transformer):
        monkeypatch.setattr(mod, "shard", lambda x, *a: x)


@pytest.mark.parametrize("model_axis,grouped", [(3, True), (2, False)])
def test_attention_under_a_mesh_takes_the_reference_branch(
        monkeypatch, model_axis, grouped):
    """The smoke llama3-8b (4 query heads over 2 kv heads, float32,
    einsum attention): under a mesh whose model axis does not divide the
    heads both packages attend grouped, with no GQA repeat; under one
    that does, both repeat the kv heads.  The loss is within 3e-4."""
    _identity_shard(monkeypatch)
    calls = []
    repeat = torch.Tensor.repeat_interleave

    def spy(self, *a, **k):
        calls.append(tuple(self.shape))
        return repeat(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", spy)
    jcfg, cfg, jp, tp = pair("llama3-8b", dtype="float32")
    jcfg = dataclasses.replace(jcfg, attn_impl="einsum")
    cfg = dataclasses.replace(cfg, attn_impl="einsum")
    assert cfg.n_heads == 4 and cfg.n_kv_heads == 2
    tok = tokens(3, 2, 24)
    sizes, names = (2, model_axis), ("data", "model")
    with j_shardctx.use_mesh(j_mesh(sizes, names)):
        want = float(jax.jit(lambda p, b: j_transformer.loss_fn(
            jcfg, p, b))(jp, {"tokens": tok, "labels": tok}))
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    with shardctx.use_mesh(sharding.NamedMesh(sizes, names)):
        got = float(transformer.loss_fn(cfg, tp, batch))
    assert abs(got - want) <= 3e-4 * max(1.0, abs(want)), (got, want)
    assert (len(calls) == 0) == grouped, calls
    # the mixer itself, one layer, against the reference's
    x = rnd(5, 2, 24, cfg.d_model)
    pos = np.arange(24)
    with j_shardctx.use_mesh(j_mesh(sizes, names)):
        jo, _ = j_attention.gqa_attention(
            x, jax.tree.map(lambda a: a[0], jp["stack"][0]["mix"]), jcfg,
            positions=pos)
    with shardctx.use_mesh(sharding.NamedMesh(sizes, names)):
        po, _ = attention.gqa_attention(
            torch.from_numpy(x), tp["layers"][0]["mix"], cfg,
            positions=torch.from_numpy(pos))
    want_o = np.asarray(jo)
    assert np.abs(t2np(po) - want_o).max() <= 3e-4 * max(
        1.0, np.abs(want_o).max())


def test_train_cli_runs_under_its_mesh(tmp_path, capsys, monkeypatch):
    """``launch.train.main`` takes the reference's non-``--full`` mesh, its
    one device's (1, 1) data x model mesh, and the params' shardings on it
    (nothing sharded at size 1), and trains under ``use_mesh``."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train

    seen = []

    def spy(name):
        seen.append((name, shardctx.axis_size(name)))
        return seen[-1][1]

    monkeypatch.setattr(attention, "axis_size", spy)
    trainer = train.main(["--steps", "1", "--device", "cpu", "--n-layers",
                          "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    n = len(tree_lib.flatten(model_zoo.abstract_params(
        smoke_config("llama3.2-1b", n_layers=1)))[0])
    assert f"mesh=1x1 sharded_leaves=0/{n}" in out
    assert trainer.step == 1 and ("model", 1) in seen
    assert shardctx.axis_size("model") == 1      # the context is gone
