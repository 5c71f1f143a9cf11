"""Multi-pod dry run: count every (arch x shape x mesh) cell on the meta
device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out <dir>
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for a 256- or 512-chip TPU v5e mesh on forced host devices and reads
XLA's memory analysis, cost analysis and partitioned HLO.  There is no
compiler here: each cell is built on PyTorch's ``meta`` device (shapes and
dtypes, no storage) with the reference's in/out sharding trees
(``distributed.sharding``) on a device-free mesh (``launch.mesh``), and

1. MEMORY pass -- ``argument_gib``, ``output_gib`` and ``alias_gib`` are
   the per-device bytes of the real program's (the ``memory`` variant's)
   arguments, outputs and donated arguments under their specs: each
   leaf's bytes over the product of its sharded axes' sizes.  Nothing
   runs.  ``temp_gib``, and so ``peak_gib`` and ``fits_16gib``, need a
   compiler's buffer assignment: ``None``, with the reason.
2. COST passes -- the reference's two shallow unrolled proxies (1x and 2x
   the layer period, ``attn_impl="einsum"``, mixer chunks = seq) run once
   on meta under ``shardctx.use_mesh``, and the run is counted: FLOPs by
   ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions and
   attention products, 2 per multiply-add), bytes by :class:`ByteCounter`
   (every aten op's operand and result bytes, views excepted: XLA's
   "bytes accessed" convention, but op by op where XLA counts fused
   kernels).  Per-device numbers are the global counts over the mesh
   size: IDEAL sharding, not a partitioned program's.  The sLSTM time
   loop is counted for one step (``models.xlstm.recurrence_counted_once``),
   as XLA counts a scan body once.  Both are extrapolated linearly to
   full depth, as in the reference.
3. Collective bytes need a partitioned program: ``None``, with the reason.
4. Roofline terms against the reference's TPU v5e constants (``hw.py``):
   a TPU model applied to these counts, not a time of any device.  The
   collective term is ``None``, and the dominant term is taken over the
   terms that exist.

Everything stays on the meta device: the dry run needs no card, and it is
not a CPU path either (it holds no storage anywhere).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import hw
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.configs.registry import cell_supported
from repro_torch.distributed import sharding, shardctx
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_zoo, xlstm
from repro_torch.models.layers import META
from repro_torch.train import tree as tree_lib
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import TrainState, make_train_step

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^=]*?"
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_GROUP_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

NO_TEMP = ("a compiler's buffer assignment (XLA's memory_analysis) has no "
           "counterpart without a compiler")
NO_COLLECTIVES = ("collective bytes are read from a partitioned program's "
                  "HLO; the port runs no partitioner")
NO_COMPILE = "no compiler: the cell is counted on the meta device"


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device OPERAND bytes per collective kind of an XLA HLO text
    (AG operand = result/shards, RS operand = result*shards, others =
    result)."""
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        if "-done(" in line:
            continue  # count async pairs once (at -start)
        nbytes = _DTYPE_BYTES.get(dtype, 4)
        for d in dims.split(","):
            if d:
                nbytes *= int(d)
        g = _GROUP_RE.search(line)
        shards = int(g.group(2)) if g else 1
        if kind == "all-gather":
            nbytes = nbytes / max(shards, 1)
        elif kind == "reduce-scatter":
            nbytes = nbytes * max(shards, 1)
        out[kind] += nbytes
    return out


# --------------------------------------------------------------------------
# Cell construction
# --------------------------------------------------------------------------

def _variant(cfg: ModelConfig, shape: ShapeCfg, *, mode: str,
             n_periods: Optional[int] = None) -> ModelConfig:
    """mode: 'memory' (real program) or 'cost' (unrolled shallow proxy)."""
    kw: Dict[str, Any] = {}
    if mode == "memory":
        kw.update(scan_layers=True, attn_impl="chunked", logit_chunk=8)
    else:
        period = cfg.layer_period
        kw.update(scan_layers=False, attn_impl="einsum", logit_chunk=1,
                  n_layers=period * n_periods + cfg.dense_first_n)
        if cfg.mamba is not None:
            kw["mamba"] = dataclasses.replace(cfg.mamba, chunk=shape.seq_len)
        if cfg.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=shape.seq_len)
    return dataclasses.replace(cfg, **kw)


def _microbatches(cfg: ModelConfig, shape: ShapeCfg) -> int:
    """Keep live activations per microbatch bounded for the giants."""
    if shape.kind != "train":
        return 1
    total = cfg.total_params()
    if total > 2e11:
        return 16
    if total > 2e10:
        return 8
    return 4 if total > 5e9 else 1


def _logits_sharding(mesh, cfg: ModelConfig, batch: int):
    spec = sharding.batch_spec(mesh, (batch, cfg.padded_vocab), batch)
    model_n = mesh.shape.get("model", 1)
    ba = spec[0] if len(spec) else None
    vspec = "model" if cfg.padded_vocab % max(model_n, 1) == 0 else None
    return sharding.NamedSharding(mesh, sharding.P(ba, vspec))


class Cell(NamedTuple):
    """One cell's program on the meta device: ``fn(*args)``, the sharding
    trees of its arguments and outputs, the donated argument positions,
    and its outputs as meta tensors."""

    fn: Any
    args: tuple
    in_shardings: tuple
    out_shardings: tuple
    donate: tuple
    outputs: tuple


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build_cell(cfg: ModelConfig, shape: ShapeCfg, mesh, *,
               num_microbatches: int = 1) -> Cell:
    """The reference's three kinds of cell: a train step (AdamW +
    ``make_train_step``), a prefill of ``seq_len`` and one decode token
    against a ``seq_len`` cache, with its in/out shardings."""
    bundle = model_zoo.build(cfg, META)
    params_abs = model_zoo.abstract_params(cfg)
    pshard = sharding.param_shardings(mesh, params_abs,
                                      ep_experts=cfg.moe_ep)
    inputs = model_zoo.input_specs(cfg, shape)
    rep = sharding.replicated(mesh)
    b = shape.global_batch
    logits = _meta((b, cfg.padded_vocab), cfg.jdtype)

    if shape.kind == "train":
        opt = AdamW(state_dtype=cfg.opt_state_dtype)
        state_abs = TrainState(params_abs, opt.init(params_abs))
        sshard = TrainState(
            pshard, state_abs.opt._replace(
                step=rep,
                m=sharding.param_shardings(mesh, state_abs.opt.m),
                v=sharding.param_shardings(mesh, state_abs.opt.v)))
        step = make_train_step(bundle.loss_fn, opt,
                               num_microbatches=num_microbatches,
                               decay=model_zoo.decay_mask(cfg))
        bshard = sharding.batch_shardings(mesh, inputs, b)
        metrics = {"loss": _meta((), torch.float32),
                   "grad_norm": _meta((), torch.float32),
                   "lr": _meta((), torch.float32),
                   "step": _meta((), torch.int32)}
        return Cell(step, (state_abs, inputs), (sshard, bshard),
                    (sshard, {k: rep for k in metrics}), (0,),
                    (state_abs, metrics))

    if shape.kind == "prefill":
        def fn(params, batch):
            return bundle.prefill(params, batch, max_seq=shape.seq_len)
        bshard = sharding.batch_shardings(mesh, inputs, b)
        if cfg.encdec is not None:
            caches_abs = bundle.init_caches(
                b, shape.seq_len, enc_len=inputs["frames"].shape[1])
        else:
            caches_abs = bundle.init_caches(b, shape.seq_len)
        cshard = sharding.cache_shardings(mesh, caches_abs, b)
        return Cell(fn, (params_abs, inputs), (pshard, bshard),
                    (_logits_sharding(mesh, cfg, b), cshard), (),
                    (logits, caches_abs))

    # decode: one new token against a seq_len cache, written at the last
    # position (the counts do not depend on it)
    caches_abs = model_zoo.abstract_caches(cfg, shape)
    cshard = sharding.cache_shardings(mesh, caches_abs, b)

    def fn(params, caches, tokens, pos):
        return bundle.decode_step(params, caches, tokens, pos)

    tok = inputs["tokens"]
    tshard = sharding.batch_shardings(mesh, tok, b)
    return Cell(fn, (params_abs, caches_abs, tok, shape.seq_len - 1),
                (pshard, cshard, tshard, rep),
                (_logits_sharding(mesh, cfg, b), cshard), (1,),
                (logits, caches_abs))


def device_bytes(tree, shardings) -> float:
    """Per-device bytes of ``tree`` under ``shardings`` (the same
    structure; a Python int, the decode position, is an int32 scalar)."""
    leaves, treedef = tree_lib.flatten(tree)
    total = 0.0
    for x, s in zip(leaves, tree_lib.flatten_up_to(treedef, shardings)):
        total += 4.0 if isinstance(x, int) else sharding.shard_bytes(x, s)
    return total


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results
    (views excepted: they move nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_lib.flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def count(fn, *args, mesh=None) -> Dict[str, float]:
    """Global FLOPs and bytes of one call ``fn(*args)`` (under
    ``use_mesh(mesh)`` when given), on whatever device its tensors are;
    an sLSTM time loop is counted for one step."""
    ctx = (shardctx.use_mesh(mesh) if mesh is not None
           else contextlib.nullcontext())
    with ctx, xlstm.recurrence_counted_once(), \
            FlopCounterMode(display=False) as flops, ByteCounter() as nb:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nb.bytes)}


def count_cell(cfg, shape, mesh, *, num_microbatches: int = 1):
    """The port's ``compile_cell``: build the cell on meta and count one
    run of it under the mesh.  Returns (global counts, build s, count s)."""
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, num_microbatches=num_microbatches)
    t1 = time.perf_counter()
    counts = count(cell.fn, *cell.args, mesh=mesh)
    return counts, t1 - t0, time.perf_counter() - t1


# --------------------------------------------------------------------------
# Roofline
# --------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeCfg) -> float:
    n = cfg.active_params()
    if shape.kind == "train":
        tok = shape.tokens
        return 6.0 * n * tok
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline(record: Dict, chips: int) -> Dict:
    """The reference's roofline on its TPU v5e constants; a term whose
    count is ``None`` is ``None`` and the dominant term is taken over the
    others."""
    spec = hw.TPU_V5E
    f = record["flops_per_device"]
    b = record["bytes_per_device"]
    c = record["collective_bytes_per_device"]
    t_comp = f / spec.peak_bf16_flops
    t_mem = b / spec.hbm_bandwidth
    t_coll = None if c is None else c / spec.ici_link_bandwidth
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    known = {k: v for k, v in terms.items() if v is not None}
    dom = max(known, key=known.get)
    bound = max(known.values())
    mf = record["model_flops"]
    hlo_global = f * chips
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "roofline_fraction_vs_compute": t_comp / bound if bound else 0.0,
        "model_flops": mf,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "achievable_model_tflops_per_chip":
            mf / bound / chips / 1e12 if bound else 0.0,
    }


def extrapolate(one: float, two: float, full_n: int) -> float:
    """cost(L) = a + b * n_periods, solved from the 1x and 2x proxies."""
    return one + (two - one) * (full_n - 1)


# --------------------------------------------------------------------------
# One cell end-to-end
# --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             skip_memory_pass: bool = False,
             config_override: Optional[ModelConfig] = None,
             shape_override: Optional[ShapeCfg] = None,
             mesh=None) -> Dict:
    """The reference's record of one cell.  ``shape_override`` and
    ``mesh`` (default: the production mesh) let a test count a smoke
    cell on a small mesh."""
    cfg = config_override or get_arch(arch)
    shape = shape_override or get_shape(shape_name)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.axis_sizes)), "chips": chips,
    }
    if not cell_supported(arch, shape_name):
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention arch: long_500k requires "
                         "sub-quadratic decode")
        return rec

    nmb = _microbatches(cfg, shape)
    # ---- memory pass: the real program's arguments under their specs ----
    if not skip_memory_pass:
        t0 = time.perf_counter()
        cell = build_cell(_variant(cfg, shape, mode="memory"), shape, mesh,
                          num_microbatches=nmb)
        arg = device_bytes(cell.args, cell.in_shardings)
        out = device_bytes(cell.outputs, cell.out_shardings)
        alias = sum(device_bytes(cell.args[i], cell.in_shardings[i])
                    for i in cell.donate)
        rec["memory"] = {
            "argument_gib": arg / 2**30,
            "output_gib": out / 2**30,
            "temp_gib": None,
            "peak_gib": None,
            "alias_gib": alias / 2**30,
            "fits_16gib": None,
            "lower_s": round(time.perf_counter() - t0, 1),
            "compile_s": None,
            "microbatches": nmb,
            "reasons": {"temp_gib": NO_TEMP, "peak_gib": NO_TEMP,
                        "fits_16gib": NO_TEMP, "compile_s": NO_COMPILE},
        }

    # ---- cost proxies: unrolled at 1 and 2 periods, counted on meta ----
    costs = {}
    for np_ in (1, 2):
        pcfg = _variant(cfg, shape, mode="cost", n_periods=np_)
        counts, _, t_count = count_cell(pcfg, shape, mesh,
                                        num_microbatches=1)
        costs[np_] = {"flops": counts["flops"] / chips,
                      "bytes": counts["bytes"] / chips,
                      "count_s": round(t_count, 1)}
    full_n = cfg.n_periods
    rec.update({
        "status": "ok",
        "flops_per_device": extrapolate(costs[1]["flops"], costs[2]["flops"],
                                        full_n),
        "bytes_per_device": extrapolate(costs[1]["bytes"], costs[2]["bytes"],
                                        full_n),
        "collective_bytes_per_device": None,
        "collective_by_kind": None,
        "proxy_compile_s": None,
        "proxy_count_s": [costs[1]["count_s"], costs[2]["count_s"]],
        "model_flops": model_flops(cfg, shape),
        "reasons": {"collective_bytes_per_device": NO_COLLECTIVES,
                    "collective_by_kind": NO_COLLECTIVES,
                    "proxy_compile_s": NO_COMPILE,
                    "flops_per_device": "global FLOPs / chips (ideal "
                                        "sharding)",
                    "bytes_per_device": "global op-by-op bytes / chips "
                                        "(ideal sharding, unfused)"},
    })
    rec["roofline"] = roofline(rec, chips)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi_pod", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-memory-pass", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for one json per cell (resumable)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi_pod": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for arch, shp, mp in cells:
        tag = f"{arch}__{shp}__{'mp' if mp else 'sp'}"
        path = os.path.join(args.out, tag + ".json") if args.out else None
        if path and os.path.exists(path):
            print(f"[skip existing] {tag}")
            continue
        t0 = time.time()
        try:
            rec = run_cell(arch, shp, multi_pod=mp,
                           skip_memory_pass=args.skip_memory_pass)
        except Exception as e:  # noqa: BLE001 -- record failures, keep going
            rec = {"arch": arch, "shape": shp,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-2000:]}
        rec["wall_s"] = round(time.time() - t0, 1)
        line = json.dumps(rec)
        if path:
            with open(path, "w") as f:
                f.write(line)
        status = rec.get("status")
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dom={r['dominant']} comp={r['compute_s']:.4f}s "
                     f"mem={r['memory_s']:.4f}s useful="
                     f"{r['useful_ratio']:.2f} (TPU v5e model)")
            if "memory" in rec:
                extra += f" args={rec['memory']['argument_gib']:.2f}GiB"
        print(f"[{status}] {tag} ({rec['wall_s']}s){extra}", flush=True)


if __name__ == "__main__":
    main()
