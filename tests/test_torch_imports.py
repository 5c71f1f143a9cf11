"""The port stands alone: it imports neither jax, nor the JAX package, nor
ml_dtypes (absent on the machine with the card), and its entry points refuse
to run on the CPU unless asked to."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.M)


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


def test_lm_entry_points_need_cuda_unless_cpu_is_asked_for():
    from repro_torch.configs import smoke_config
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import Request, ServeEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    cfg = smoke_config("llama3.2-1b", n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_zoo.build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_zoo.params_from_reference({}, cfg)
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init_params(0)
    assert params["embed"].device.type == "cpu"
    out = ServeEngine(bundle, params, slots=1, max_seq=8).generate(
        [Request(np.arange(3, dtype=np.int32), max_new_tokens=2)])
    assert len(out[0].tokens) == 2


def test_lm_kernels_on_cpu_tensors_take_the_plain_versions():
    import repro_torch.kernels as K
    from repro_torch.core import profiler
    from repro_torch.kernels import dispatch, ops

    K.reset_launch_counts()
    x = torch.randn(40, 24, dtype=torch.bfloat16)
    assert profiler.block_counts(x, (16, 16)).tolist() == [[256, 128]] * 2 \
        + [[128, 64]]
    assert dispatch.tile_occupancy(x).dtype == torch.uint8
    q = torch.randn(1, 4, 8, 16)
    kv = torch.randn(1, 2, 8, 16)
    assert ops.flash_attention(q, kv, kv, causal=True).shape == q.shape
    assert all(v == 0 for v in K.launch_counts().values())
    assert {"tile_nnz", "flash_attention"} <= set(K.launch_counts())


@pytest.mark.parametrize("module,names", [
    ("repro_torch.core.formats",
     "COOMatrix CSRMatrix dense_to_coo coo_to_dense dense_to_csr _csr_rows "
     "csr_to_dense coo_to_csr csr_to_coo csr_to_ell"),
    ("repro_torch.core.profiler",
     "tile_occupancy block_tile_density block_density_from_mask"),
    ("repro_torch.core.perf_model", "predict_output_density"),
    ("repro_torch.core.analyzer",
     "plan_kernel_host TaskPlan plan_task plan_kernel primitive_histogram"),
    ("repro_torch.core.runtime",
     "propagate_stats _pool_rows _operand_block_densities "
     "simulate_inference"),
    ("repro_torch.models.gnn", "SimGNN build_sim"),
    ("repro_torch.data.graphs", "block_stats weight_stats _block_sizes"),
    ("repro_torch.core.dynasparse", "dynasparse_dense_equivalent")])
def test_simulator_slice_imports_no_jax(module, names):
    """The simulator slice's names live in the port and pull in neither
    jax nor the JAX package."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        f"missing = [n for n in {names.split()!r} if not hasattr(m, n)]\n"
        "assert not missing, missing\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("module,names", [
    ("repro_torch.models.layers",
     "moe_capacity moe_routing moe_ffn init_moe"),
    ("repro_torch.models.attention", "init_mla mla_attention"),
    ("repro_torch.models.ssm", "init_mamba _causal_conv _ssm_chunk "
     "mamba_mixer"),
    ("repro_torch.models.xlstm", "init_mlstm _mlstm_parallel mlstm_mixer "
     "init_slstm slstm_mixer"),
    ("repro_torch.models.encdec",
     "ENC_DECODE_LEN sinusoid init_params encode decoder_forward loss_fn "
     "init_caches prefill decode_step"),
    ("repro_torch.models.transformer",
     "init_block apply_block _cache_for_kind init_caches forward"),
    ("repro_torch.configs.registry",
     "ARCHS SHAPES SUBQUADRATIC get_arch get_shape cell_supported "
     "smoke_config"),
    ("repro_torch.launch.serve",
     "prune_ffn leaf_groups magnitude_threshold generate_encdec")])
def test_lm_layer_kinds_import_no_jax(module, names):
    """The LM layer kinds (MoE, MLA, mamba, xLSTM, encoder-decoder) live in
    the port and pull in neither jax nor the JAX package."""
    test_simulator_slice_imports_no_jax(module, names)


def test_the_dense_only_guard_is_gone():
    from repro_torch.configs import ARCHS
    from repro_torch.models import model_zoo, transformer

    assert not hasattr(transformer, "check_dense")
    assert not hasattr(transformer, "NOT_PORTED")
    assert len(ARCHS) == 10
    for cfg in ARCHS.values():
        model_zoo.build(cfg, device="cpu")


def test_the_distributed_package_is_covered():
    mods = _port_modules()
    assert {"repro_torch.distributed",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.shardctx",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun"} <= set(mods)


def test_a_mesh_of_cards_needs_the_cards():
    """A mesh of CUDA devices without them raises, as the reference's
    ``cores_mesh`` does past the visible devices; emulated lanes on the
    CPU are asked for by name."""
    from repro_torch.distributed import sharding

    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="devices visible"):
        sharding.cores_mesh(visible + 1)
    with pytest.raises(ValueError, match="devices visible"):
        sharding.cores_mesh(0)
    assert sharding.cores_mesh(3, device="cpu").size == 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.cores_mesh(2, device="cuda")


TRAINING_SLICE = {
    "repro_torch.data.tokens": "TokenPipeline",
    "repro_torch.train.tree": "flatten unflatten flatten_up_to tree_map "
                              "describe",
    "repro_torch.train.optimizer": "AdamW AdamWState Quantized _quantize "
                                   "_dequantize global_norm",
    "repro_torch.train.checkpoint": "save save_async wait latest_step "
                                    "restore gc_old",
    "repro_torch.train.trainer": "TrainState make_train_step Trainer",
    "repro_torch.launch.train": "main",
    "repro_torch.core.dynasparse": "BlockMatmulFn",
    "repro_torch.models.model_zoo": "decay_mask"}


def test_training_slice_imports_no_jax():
    """The training slice (``train/*``, ``data/tokens.py``,
    ``launch/train.py``, the dispatch backward, the decay mask) lives in
    the port and pulls in neither jax, nor the JAX package, nor ml_dtypes:
    one fresh process imports all of it."""
    code = (
        "import importlib, sys\n"
        f"for name, names in {TRAINING_SLICE!r}.items():\n"
        "    m = importlib.import_module(name)\n"
        "    missing = [n for n in names.split() if not hasattr(m, n)]\n"
        "    assert not missing, (name, missing)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_training_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    """``launch.train.main`` runs on the card by default and raises without
    one; ``model_zoo.decay_mask`` takes no device (it reads the params'
    shapes on the meta device), so it works on any machine."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train
    from repro_torch.models import model_zoo

    mask = model_zoo.decay_mask(smoke_config("llama3.2-1b"))
    assert mask["embed"] is True
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--device", "cuda"])
    trainer = train.main(["--steps", "1", "--device", "cpu", "--n-layers",
                          "1", "--ckpt-dir", str(tmp_path)])
    assert trainer.step == 1
    assert tree_devices(trainer.state) == {"cpu"}


def tree_devices(tree):
    from repro_torch.train import tree as tree_lib
    return {t.device.type for t in tree_lib.flatten(tree)[0]}


DRY_RUN_SLICE = {
    "repro_torch.launch.mesh": "make_production_mesh make_test_mesh",
    "repro_torch.distributed.sharding":
        "NamedMesh PartitionSpec P NamedSharding batch_axes _axsize "
        "ROW_PARALLEL_NAMES param_spec _is_row_parallel _is_expert "
        "expert_param_spec param_shardings cache_spec cache_shardings "
        "batch_spec batch_shardings replicated describe shard_bytes",
    "repro_torch.distributed.shardctx": "use_mesh axis_size shard",
    "repro_torch.distributed.collectives":
        "quantize_int8 dequantize_int8 compressed_psum "
        "compressed_grad_allreduce init_residual",
    "repro_torch.launch.dryrun":
        "collective_bytes _variant _microbatches _logits_sharding "
        "build_cell count_cell count ByteCounter model_flops roofline "
        "extrapolate run_cell main",
    "repro_torch.models.model_zoo":
        "input_specs abstract_params abstract_caches",
    "repro_torch.models.xlstm": "recurrence_counted_once",
    "repro_torch.core.perf_model": "FPGACostModel",
    "repro_torch.kernels.ops": "tile_nnz",
    "repro_torch.train.tree": "flatten_with_path tree_map_with_path"}


def test_dry_run_slice_imports_no_jax():
    """The dry run's slice (the meshes, the LM sharding rules, shardctx,
    the int8 collectives, the dry run itself, the abstract builders, the
    padded ``ops.tile_nnz``) lives in the port and pulls in neither jax,
    nor the JAX package, nor ml_dtypes: one fresh process imports all of
    it.  ``FPGACostModel`` has the reference's ``seconds``."""
    code = (
        "import importlib, sys\n"
        f"for name, names in {DRY_RUN_SLICE!r}.items():\n"
        "    m = importlib.import_module(name)\n"
        "    missing = [n for n in names.split() if not hasattr(m, n)]\n"
        "    assert not missing, (name, missing)\n"
        "from repro_torch.core.perf_model import FPGACostModel\n"
        "assert hasattr(FPGACostModel, 'seconds')\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'repro', 'ml_dtypes')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_the_dry_run_needs_no_card():
    """The dry run counts a cell on the meta device, with or without a
    card: no tensor of it has storage."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun, mesh

    rec = dryrun.run_cell("xlstm-125m", "t",
                          config_override=smoke_config("xlstm-125m"),
                          shape_override=ShapeCfg("t", 32, 4, "decode"),
                          mesh=mesh.make_test_mesh(8, 4))
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
