"""The dry run's cells and host functions (``repro_torch.launch.dryrun``)
against the JAX package's, and the two leftovers of earlier slices
(``FPGACostModel.seconds``, the padded ``kernels.ops.tile_nnz``).

One subprocess with 8 forced host devices (the reference's dry-run module
sets a 512-device flag when imported, so it is never imported here)
compiles two smoke cells with the reference's own ``compile_cell`` on a
(2, 4) mesh with Auto axes, as its ``run_cell`` compiles them (the
unrolled 1-period cost proxy): the 2-layer llama3-8b's train cell at
``ShapeCfg("t", 64, 8, "train")`` and its decode cell at
``ShapeCfg("d", 128, 8, "decode")``.  It writes their partitioned HLO
texts, ``cost_analysis`` FLOPs and bytes, and the reference's pure host
functions on the same inputs (``collective_bytes``, ``_variant``,
``_microbatches``, ``model_flops``, ``roofline``, and ``run_cell``'s
linear extrapolation with the compiles replaced by fixed numbers).
The port must give the same values exactly.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_config as j_smoke
from repro.core import perf_model as j_pm
from repro.distributed import sharding as j_sharding
from repro.kernels import ops as j_ops
from repro.models import model_zoo as j_zoo
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs import ARCHS, SHAPES, get_arch, smoke_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import perf_model as p_pm
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(ARCHS)
TRAIN = ShapeCfg("t", 64, 8, "train")
DECODE = ShapeCfg("d", 128, 8, "decode")
PREFILL = ShapeCfg("p", 64, 8, "prefill")

# (proxy n_layers -> (flops, bytes, one collective op line)) stand-ins for
# the reference's compiles when its run_cell's extrapolation is checked
FAKE = {1: (1.25e12, 3.5e10, 2048), 2: (2.75e12, 6.0e10, 6144)}

REFERENCE = """
    import dataclasses, json, sys
    import jax
    from jax.sharding import AbstractMesh, AxisType
    from repro.configs import ARCHS, SHAPES, get_arch, smoke_config
    from repro.configs.base import ShapeCfg
    from repro.launch import dryrun

    out_dir = sys.argv[1]
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cells = {{"train": (smoke_config("llama3-8b", n_layers=2),
                       ShapeCfg("t", 64, 8, "train")),
             "decode": (smoke_config("llama3-8b", n_layers=2),
                        ShapeCfg("d", 128, 8, "decode"))}}
    rec = {{"cells": {{}}}}
    for name, (cfg, shape) in cells.items():
        # the cell's unrolled 1-period cost proxy, as run_cell compiles it
        proxy = dryrun._variant(cfg, shape, mode="cost", n_periods=1)
        compiled, _, _ = dryrun.compile_cell(proxy, shape, mesh)
        ca = dryrun.cost_analysis_dict(compiled)
        text = compiled.as_text()
        with open(f"{{out_dir}}/{{name}}.hlo", "w") as f:
            f.write(text)
        rec["cells"][name] = {{"flops": float(ca["flops"]),
                              "bytes": float(ca["bytes accessed"]),
                              "coll": dryrun.collective_bytes(text)}}

    def variant(cfg, shape, mode, n):
        return dataclasses.asdict(dryrun._variant(cfg, shape, mode=mode,
                                                  n_periods=n))
    rec["variant"] = {{f"{{a}}|{{s}}|{{m}}|{{n}}": variant(get_arch(a),
                                                     SHAPES[s], m, n)
                      for a in ARCHS for s in SHAPES
                      for m, n in (("memory", None), ("cost", 1),
                                   ("cost", 2))}}
    rec["microbatches"] = {{f"{{a}}|{{s}}": dryrun._microbatches(
        get_arch(a), SHAPES[s]) for a in ARCHS for s in SHAPES}}
    rec["model_flops"] = {{f"{{a}}|{{s}}": dryrun.model_flops(
        get_arch(a), SHAPES[s]) for a in ARCHS for s in SHAPES}}
    rec["roofline"] = {{}}
    for name, c in rec["cells"].items():
        r = {{"flops_per_device": c["flops"], "bytes_per_device": c["bytes"],
             "collective_bytes_per_device": sum(c["coll"].values()),
             "model_flops": 1.5e9}}
        rec["roofline"][name] = [r, dryrun.roofline(r, 8)]

    # run_cell's extrapolation through its own code: compiles replaced by
    # fixed numbers, keyed by the proxy's depth in periods
    fake = {fake!r}

    class Fake:
        def __init__(self, cfg):
            self.n = (cfg.n_layers - cfg.dense_first_n) // cfg.layer_period
        def cost_analysis(self):
            return {{"flops": fake[self.n][0],
                    "bytes accessed": fake[self.n][1]}}
        def as_text(self):
            return ("  ar = f32[%d]{{0}} all-reduce(f32[%d]{{0}} x), "
                    "replica_groups=[2,4]<=[8]" % ((fake[self.n][2],) * 2))

    dryrun.compile_cell = lambda cfg, shape, mesh, **kw: (Fake(cfg), 0.0,
                                                          0.0)
    dryrun.make_production_mesh = lambda multi_pod=False: AbstractMesh(
        (16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rec["run_cell"] = {{a: dryrun.run_cell(a, "train_4k",
                                          skip_memory_pass=True)
                       for a in ("llama3.2-1b", "jamba-v0.1-52b",
                                 "deepseek-v2-lite-16b")}}
    with open(f"{{out_dir}}/ref.json", "w") as f:
        json.dump(rec, f)
    print("REF DONE")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(fake=FAKE)),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((out / "ref.json").read_text())
    rec["hlo"] = {n: (out / f"{n}.hlo").read_text() for n in rec["cells"]}
    return rec


@pytest.mark.parametrize("cell", ["train", "decode"])
def test_collective_bytes_equals_the_reference_on_its_own_hlo(ref, cell):
    text = ref["hlo"][cell]
    got = dryrun.collective_bytes(text)
    assert got == ref["cells"][cell]["coll"]
    # the text holds at least one collective of each kind it emits
    for kind, nbytes in got.items():
        if nbytes:
            assert f" {kind}(" in text or f" {kind}-start(" in text, kind
    assert sum(got.values()) > 0


def test_variant_microbatches_and_model_flops_equal_the_reference(ref):
    for key, want in ref["variant"].items():
        a, s, m, n = key.split("|")
        got = dryrun._variant(get_arch(a), SHAPES[s], mode=m,
                              n_periods=None if n == "None" else int(n))
        assert json.loads(json.dumps(dataclasses.asdict(got))) == want, key
    for key, want in ref["microbatches"].items():
        a, s = key.split("|")
        assert dryrun._microbatches(get_arch(a), SHAPES[s]) == want, key
    for key, want in ref["model_flops"].items():
        a, s = key.split("|")
        assert dryrun.model_flops(get_arch(a), SHAPES[s]) == want, key


@pytest.mark.parametrize("cell", ["train", "decode"])
def test_roofline_equals_the_reference(ref, cell):
    record, want = ref["roofline"][cell]
    assert dryrun.roofline(record, 8) == want
    # without collective bytes the term is None and the dominant term is
    # the larger of the other two
    got = dryrun.roofline({**record, "collective_bytes_per_device": None}, 8)
    assert got["collective_s"] is None
    assert got["dominant"] == ("compute" if want["compute_s"]
                               >= want["memory_s"] else "memory")
    assert got["bound_s"] == max(want["compute_s"], want["memory_s"])


def test_extrapolation_equals_the_reference_run_cell(ref):
    """The reference's run_cell on fixed proxy numbers: the port's
    ``extrapolate`` and ``roofline`` on the same numbers give its record's
    values bit for bit (collective bytes included, through the
    reference's own HLO parser)."""
    for arch, want in ref["run_cell"].items():
        n = get_arch(arch).n_periods
        f = dryrun.extrapolate(FAKE[1][0], FAKE[2][0], n)
        b = dryrun.extrapolate(FAKE[1][1], FAKE[2][1], n)
        c = dryrun.extrapolate(FAKE[1][2] * 4.0, FAKE[2][2] * 4.0, n)
        assert (f, b, c) == (want["flops_per_device"],
                             want["bytes_per_device"],
                             want["collective_bytes_per_device"]), arch
        assert dryrun.model_flops(get_arch(arch), SHAPES["train_4k"]) == \
            want["model_flops"]
        rec = {"flops_per_device": f, "bytes_per_device": b,
               "collective_bytes_per_device": c,
               "model_flops": want["model_flops"]}
        assert dryrun.roofline(rec, 256) == want["roofline"], arch


def test_smoke_cells_counted_beside_the_reference_cost_analysis(ref):
    """The two smoke cells' unrolled 1-period cost proxies counted by the
    port on meta (ideal sharding over 8 devices) beside the reference's
    ``cost_analysis`` of the same proxies: each ratio is printed (``-s``)
    for PERF.md.  The port counts matmul FLOPs only, where XLA counts
    every element op too, and bytes op by op, where XLA counts fused
    kernels."""
    mesh = make_test_mesh(8, 4)
    cells = {"train": (smoke_config("llama3-8b", n_layers=2), TRAIN),
             "decode": (smoke_config("llama3-8b", n_layers=2), DECODE)}
    for name, (cfg, shape) in cells.items():
        proxy = dryrun._variant(cfg, shape, mode="cost", n_periods=1)
        counts, _, _ = dryrun.count_cell(proxy, shape, mesh)
        want = ref["cells"][name]
        ratio = {k: counts[k] / 8 / want[k] for k in ("flops", "bytes")}
        print(f"smoke {name} proxy: port/reference per-device flops "
              f"{ratio['flops']:.4f} ({counts['flops'] / 8:.6g} / "
              f"{want['flops']:.6g}), bytes {ratio['bytes']:.4f} "
              f"({counts['bytes'] / 8:.6g} / {want['bytes']:.6g})")
        assert counts["flops"] > 0 and counts["bytes"] > 0


def test_count_of_one_matmul():
    a = torch.empty((32, 48), device="meta")
    b = torch.empty((48, 16), device="meta")
    got = dryrun.count(lambda: a @ b)
    assert got == {"flops": 2.0 * 32 * 48 * 16,
                   "bytes": 4.0 * (32 * 48 + 48 * 16 + 32 * 16)}
    # views move nothing
    assert dryrun.count(lambda: (a.T, a.view(-1), a[:3]))["bytes"] == 0


# --------------------------------------------------------------------------
# run_cell on the smoke configs of all ten archs, on the (2, 4) test mesh
# --------------------------------------------------------------------------

def _ref_arg_bytes(arch, shape):
    """Per-device bytes of the reference's train-cell arguments (unrolled
    params, AdamW state, batch) under the reference's own specs on the
    (2, 4) mesh."""
    cfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    mesh = AbstractMesh((2, 4), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)
    params = j_zoo.abstract_params(cfg)
    opt = jax.eval_shape(JAdamW(state_dtype=cfg.opt_state_dtype).init,
                         params)
    inputs = j_zoo.input_specs(cfg, shape)
    trees = [(params, j_sharding.param_shardings(mesh, params)),
             (opt.m, j_sharding.param_shardings(mesh, opt.m)),
             (opt.v, j_sharding.param_shardings(mesh, opt.v)),
             (inputs, j_sharding.batch_shardings(mesh, inputs,
                                                 shape.global_batch))]
    total = 4.0          # the step counter
    for tree, sh in trees:
        for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(sh)):
            div = math.prod(mesh.shape[a] for d in s.spec if d is not None
                            for a in ((d,) if isinstance(d, str) else d))
            total += x.size * np.dtype(x.dtype).itemsize / div
    return total


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_run_cell_on_smoke_configs(arch):
    mesh = make_test_mesh(8, 4)
    cfg = smoke_config(arch)
    # prefill on the two families whose prefill differs (decoder-only,
    # encoder-decoder with its cross caches over the frames)
    shapes = (TRAIN, DECODE) + ((PREFILL,) if arch in (
        "llama3.2-1b", "whisper-large-v3") else ())
    for shape in shapes:
        rec = dryrun.run_cell(arch, shape.name, config_override=cfg,
                              shape_override=shape, mesh=mesh)
        assert rec["status"] == "ok" and rec["mesh"] == "2x4"
        assert rec["chips"] == 8
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        for key in ("collective_bytes_per_device", "collective_by_kind"):
            assert rec[key] is None and rec["reasons"][key]
        mem = rec["memory"]
        for key in ("temp_gib", "peak_gib", "fits_16gib"):
            assert mem[key] is None and mem["reasons"][key]
        assert mem["argument_gib"] > 0 and mem["output_gib"] > 0
        r = rec["roofline"]
        assert r["collective_s"] is None
        assert r["dominant"] in ("compute", "memory")
        assert r["bound_s"] == max(r["compute_s"], r["memory_s"])
        assert rec["model_flops"] == dryrun.model_flops(cfg, shape)
        if shape.kind == "train":
            assert mem["argument_gib"] * 2**30 == pytest.approx(
                _ref_arg_bytes(arch, shape), rel=1e-12)
            assert mem["alias_gib"] * 2**30 < mem["argument_gib"] * 2**30
        if shape.kind == "decode":
            assert 0 < mem["alias_gib"] < mem["argument_gib"]


def test_unsupported_cells_are_skipped_as_the_reference_says():
    rec = dryrun.run_cell("llama3.2-1b", "long_500k")
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", multi_pod=True)
    assert rec["mesh"] == "2x16x16" and rec["chips"] == 512


def test_cli_writes_one_record_per_cell(tmp_path, capsys):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["llama3.2-1b__long_500k__mp.json",
                     "llama3.2-1b__long_500k__sp.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["status"] == "skipped" and "wall_s" in rec
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    assert "[skip existing]" in capsys.readouterr().out


def test_the_sweep_is_not_a_cpu_path():
    """Every tensor of a cell lies on the meta device: no storage."""
    cell = dryrun.build_cell(smoke_config("llama3.2-1b"), TRAIN,
                             make_test_mesh(8, 4))
    from repro_torch.train import tree as tree_lib
    leaves = [x for x in tree_lib.flatten(cell.args)[0]
              if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device.type == "meta" for x in leaves)


# --------------------------------------------------------------------------
# the leftovers: FPGACostModel.seconds and the padded ops.tile_nnz
# --------------------------------------------------------------------------

def _grid(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((33, 17))
    a[rng.random(a.shape) < 0.2] = 0.0
    a.flat[:4] = [0.0, 1.0, 0.5, 0.125]
    return a


@pytest.mark.parametrize("prim", list(p_pm.Primitive))
def test_fpga_seconds_equals_the_reference(prim):
    rmodel, pmodel = j_pm.FPGACostModel(), p_pm.FPGACostModel()
    jprim = j_pm.Primitive(int(prim))
    ax, ay = _grid(1), _grid(2)
    for m, n, d in ((16, 16, 16), (128, 128, 128), (3327, 16, 3703)):
        # host floats (numpy float64)
        np.testing.assert_array_equal(
            pmodel.seconds(prim, m, n, d, ax, ay),
            rmodel.seconds(jprim, m, n, d, ax, ay))
        # device arrays (float32), eagerly
        want = np.asarray(rmodel.seconds(jprim, m, n, d,
                                         jnp.asarray(ax, jnp.float32),
                                         jnp.asarray(ay, jnp.float32)))
        got = pmodel.seconds(prim, m, n, d,
                             torch.from_numpy(ax.astype(np.float32)),
                             torch.from_numpy(ay.astype(np.float32)))
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes()
    assert pmodel.seconds(p_pm.Primitive.GEMM, 16, 16, 16, 0.5, 0.5) == \
        rmodel.seconds(j_pm.Primitive.GEMM, 16, 16, 16, 0.5, 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,tile", [(300, 200, (128, 128)),
                                      (17, 33, (16, 16)),
                                      (257, 256, (256, 128)),
                                      (5, 7, (8, 8))])
def test_padded_tile_nnz_equals_the_reference(dtype, m, n, tile):
    rng = np.random.default_rng(m * n)
    x = rng.standard_normal((m, n)).astype(np.float32)
    x[rng.random((m, n)) < 0.7] = 0.0
    x[: tile[0]] = 0.0                       # an all-zero tile row
    want = np.asarray(j_ops.tile_nnz(jnp.asarray(x).astype(dtype),
                                     tile=tile, interpret=True))
    got = ops.tile_nnz(torch.from_numpy(x).to(getattr(torch, dtype)),
                       tile=tile)
    assert got.dtype == torch.int32
    assert got.shape == (-(-m // tile[0]), -(-n // tile[1]))
    np.testing.assert_array_equal(got.numpy(), want)
