#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds every kernel against its plain PyTorch version on the
card at the shapes its path gives it, then drives the port's paths:

* GraphSAGE on full-size CiteSeer (3327 vertices, 3703 features, hidden
  16, 6 classes, random seeded weights) through both engines, checked
  against a float64 dense oracle (GCN, row-CSR and ``ops.matmul`` too);
* GAT on the same graph (2 layers x 2 heads, slope 0.2, threshold 0.02):
  the masked edge-softmax kernel ``edge_softmax`` against its plain
  version on layer 1 head 1's operands, in float32 and bf16, its fused
  block counts against ``tile_nnz`` of the alpha as stored (alpha's
  SHA-256 recorded), then both engines under every strategy and the
  row-CSR route, held to the JAX planner's histograms and to a float64
  oracle on the run's own attention support, with 4 ``tile_nnz``
  launches fewer per inference than when alpha was counted apart;
* batched graph serving (``GraphServeEngine.serve``): the batched
  ``tile_nnz`` route (one launch per stack, grid z the slot) against
  per-slot 2-D launches and its plain version, exactly; the reference's
  serving stream (``benchmarks/bench_serving.py``: 16 requests of
  56/100/150 vertices, f_in 64, waves of 4) through all five models,
  SAGE's static strategies and GCN's row-CSR route, each == ``run_naive``
  bitwise with one walk plan per bucket, one batched launch per (request
  input, granularity) per wave, no host synchronization inside
  ``launch_batch`` and all-SKIP dummy slots; then SAGE at CiteSeer's
  widths (12 requests up to 3327 vertices, 3703 features, buckets 1024 /
  2048 / 4096), == ``run_naive`` bitwise and within 2e-4 of a float64
  oracle per request, with wave walls, gather and copy times, device
  busy and requests/s served and naive;
* continuous serving (``ContinuousGraphServer``): the reference's
  continuous parity stream (``benchmarks/bench_serving.py``: 6 requests,
  waves of 3, ``max_wait`` 0.01) through all five models and GCN's
  row-CSR route, == ``run_naive`` bitwise; the scheduler's policy under a
  fake clock with scripted walls, equal on the card and on the CPU, with
  full, deadline, age and drain cuts and sheds; then SAGE at CiteSeer's
  widths: two waves in flight against one over 24 requests (no host
  synchronization in ``begin_wave`` while a wave is in flight, pinned
  buffers released), and the reference's deep overload replay, 96
  requests arriving at 1x, 3x and 10x the measured capacity, under
  ``shed="never"`` and ``"predicted-miss"``, each delivered + shed ==
  submitted and == ``run_naive`` bitwise, with hit-rates, goodput,
  sojourns, the EWMA wave-wall estimate against each wave's marginal
  wall, the device's idle share and the host's pinned and resident
  memory;
* the cost-model simulator (``build_sim``, ``simulate``): all six Table VI
  graphs at full scale with GCN, GraphSAGE, GIN and SGC, four mappings
  under the FPGA model and Algorithm 7 under the TPU model, planned on the
  card and held to the same calls on the CPU (histograms and makespans
  equal), with the reference's simulator gates and the modeled Alveo U250
  Table VII row of each pair; the flat COO/CSR formats of CiteSeer's
  A_mean on the card against the CPU's, ``csr_spmm`` over ``csr_to_ell``
  against the ELL route, and ``block_tile_density`` through ``tile_nnz``;
* multi-device wave dispatch (``mesh=``, ``submesh=``, ``resize``): SAGE
  at CiteSeer's widths on ``cores_mesh(1)``, the card, == the unsharded
  serve == ``run_naive`` bitwise with the same launches; on 4 emulated
  lanes of the one card (one slot each; they run one after another, so
  their walls measure no multi-device speed) and on the groups of a
  ``[2, 1, 1]`` partition, bitwise, with ``tile_nnz_batched`` launched
  once per lane per request input; SAGE ``s1`` and GCN row-CSR streams
  across the lanes (``spdmm``, ``csr_spmm``); the scripted stream
  through a ``resize``/``autoscale`` server on the 4 lanes, its dispatch
  log and group plans equal to the CPU's; wave walls per lane count and
  device busy time;
* llama3.2-1b at full width (16 layers, d_model 2048, 32/8 heads, d_ff
  8192, vocab 128256, bf16, random seeded weights): the scoring forward
  (``loss_fn``) with ``attn_impl="flash"`` on 2 x 2048 tokens, checked
  against the ``chunked`` attention, in bf16 and (phase 8b) in float32
  (the float32 flash route, 16 launches, its loss within ``TOL`` of the
  chunked float32 loss); and ``ServeEngine`` on 8 requests of
  128 prompt tokens + 16 new tokens with FFN weights pruned to density
  0.1, once with ``dynasparse_ffn`` (tile_nnz + dispatch at (256, 256,
  256)) and once dense; then the smoke config's dynasparse == dense
  tokens and decode == full-forward logits on the card;
* the LM families at full width (phase 10, random seeded weights):
  deepseek-v2-lite-16b (27 layers: MLA, 64 routed + 2 shared experts
  top-6, a dense-first layer of d_ff 10944; bf16, FFN and experts pruned
  to 0.1) served by ``ServeEngine`` (4 slots, 4 requests of 64 + 8
  tokens) with and without ``dynasparse_ffn``, ``dispatch`` checked and
  timed at its dense-first (ragged N 10944) and shared-expert decode
  shapes, decode against the full forward with a dropless MoE and every
  MLA layer's absorbed decode against its plain one; one period of
  jamba-v0.1-52b (8 layers, float32) and xlstm-125m (float32), each
  decode against its full forward, jamba's dense FFNs on ``dispatch``;
  whisper-large-v3 on 2 x 3000 stub frames, 8 greedy steps against
  ``decoder_forward``; then the ten archs' smoke configs;
* LM training (phase 11): the reference's masked VJP of ``dispatch`` at
  llama3.2-1b's FFN shapes, bf16 (``dispatch_bwd``: wgmma fed by TMA)
  and float32 (``dispatch_bwd``'s float32 route: FMA microtiles fed by
  cp.async), the forward's operands and code grid read in place (no copy
  kernel in a profiled float32 forward and backward), against autograd
  through the plain version, dx exactly 0 where the forward SKIPped;
  ``dispatch_bwd`` against its plain versions (bf16: float32 sums within
  ``DISPATCH_BF16_TOL``, its bf16 result their rounding bitwise;
  float32: within ``TOL`` of the largest |want|, and whether it equals
  the two ``dispatch`` launches over the permuted grid that served
  float32 before, timed beside it) and timed at the four FFN products,
  on a grid with half of w1's blocks SKIPped and at deepseek's ragged
  2048 x 10944 dense-first w1; the forward of the same products as
  ``BlockMatmulFn`` runs it (bf16 on the walk's mma route; float32 on
  ``dispatch.block_matmul_nn``, the float32 backward's kernel in its nn
  layout, bitwise the walk, timed beside it and ``torch.matmul``);
  llama3.2-1b at full width trained 4 steps (batch 8 x 256, lr 3e-3,
  float32 AdamW state) with ``dynasparse_ffn`` through
  ``make_train_step`` + ``Trainer`` + ``TokenPipeline`` (48 ``dispatch``,
  96 ``dispatch_bwd`` and 144 ``tile_nnz`` a step) and dense;
  ``launch/train.py`` with a failure at step 2 restarting from its
  step-2 checkpoint, equal to the uninterrupted dense run; one warm and
  one profiled float32 dynasparse step (the same launches a step; the
  profile shows 48 forward launches on the tiled kernel and none on the
  walk), its first loss and gradient norm equal bitwise to the same step
  with the forward on the walk and within ``TOL`` of a dense float32 step
  on the same weights and batch;
* the dry run (phase 12): the int8 error-feedback gradient all-reduce
  (``distributed.collectives``) over a one-rank NCCL group on a tree of
  llama3.2-1b's full-width gradient shapes, timed beside its bytes-moved
  bound, its mean and residual bitwise the same call on the CPU over a
  gloo group; the padded ``kernels.ops.tile_nnz`` (one ``tile_nnz``
  launch at 2047 x 8191, exact); the FLOPs ``FlopCounterMode`` counts for
  llama3.2-1b's train_4k cost proxy and a prefill at 1 x 4096 tokens,
  equal on the meta device and on the card, with the card's time and
  TFLOP/s; then ``launch.dryrun.run_cell`` over the ten archs x four
  shapes on the production 16x16 mesh (meta device: no storage), each
  cell ``ok`` or ``skipped`` as ``cell_supported`` says, with every
  argument and output leaf under a spec.

bf16 operands run on the tensor-core routes of ``dispatch`` and
``flash_attention`` (``mma.sync``) and ``dispatch_bwd`` (``wgmma``),
float32 on the FP32 FMA routes (register microtiles fed by ``cp.async``
or double buffers); the kernels line names both routes of
``flash_attention`` and ``dispatch_bwd``, the float32 ones with the
launches of the float32 scoring batch and training steps; each
``kernel`` record names its route (``mma``, ``fma``, or ``simt`` for the
integer ``tile_nnz``).  ``gemm`` is also timed at the 16-wide shapes the
path launches, and must equal the float32 ``dispatch`` with all-GEMM codes
and one k-block bit for bit; the float32 ``dispatch`` must equal its plain
version bit for bit on the planner's grid; the block-sparse ``spdmm`` (on
A_mean @ H0, an Update and A_mean @ H1) and ``spmm`` (A_mean x H0) must
equal ``gemm`` bit for bit, and are timed beside the fastest single
PyTorch call of the same product (``torch.sparse.mm`` of the operand in
BSR or CSR, or dense ``torch.matmul``).  The row-CSR ``csr_spmm`` (ELL of
A_mean at rmax 576) must equal ``gemm`` bit for bit at both Aggregate
shapes of the CSR phase (N1 @ H0, N2 @ H1) and is timed at both, beside
the same library calls and CSR ``torch.sparse.mm`` of the operands padded
to 16-multiples; it is also checked in bf16, on a 600-slot row at widths
1, 17 and 3703, with ``run`` = 0 and into a wider buffer.  The bf16
static strategies (``gemm``/``s1``/``s2``) and the bf16 CSR route run
through ``dynasparse_matmul`` on the card, held against the plain route;
one format-aware SAGE inference is profiled per kernel and fused.  The
bf16 ``dispatch`` is timed on both FFN products (w1: 2048 -> 8192, w2:
8192 -> 2048) at prefill and decode shapes and checked at decode row
counts 1, 4, 17 and 300.

Times come from CUDA events (kernels) and the host clock around
synchronised work (paths).  Each path resets the kernels' launch counters
just before it runs and reads them just after; a kernel of a path that
was never launched fails the run.

Output: plain records, the card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  A full record is also written to
``chiprun_out/chip_smoke.json``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA.
Float32 matmuls run in full float32 (TF32 is switched off for both
``torch.matmul`` and cuDNN) so the plain versions and the oracle are exact
references.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 3e-4            # kernel vs plain version (tests/test_kernels.py:39)
BF16_TOL = 5e-2       # bf16 kernel vs plain version (ROADMAP slice rule)
DISPATCH_BF16_TOL = 1e-4   # bf16 dispatch vs plain: both sum the same
                      # exact bf16 products in float32 (max|err| measured on
                      # an H100: 1.7e-6), so one stale 32-wide k slice of a
                      # tile (~1e-2) fails
FLASH_TOL = 1e-2      # bf16 flash vs plain: outputs are ~0.05 typical, 3.7
                      # at most; max|err| is one bf16 step at the largest
                      # (1.6e-2 at |want| in [2, 4), inside atol + rtol|want|)
MODEL_TOL = 2e-4      # engine outputs (tests/test_unified_executor.py:90)
LM_REL = 3e-2         # LM outputs, relative (tests/test_models_smoke.py:85)
LOSS_TOL = 1e-2       # flash vs chunked scoring loss
PEAK_FP32 = 67e12     # H100 SXM, FP32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12    # H100 SXM, bf16 dense tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
REF_SAGE_CI_HIST = [443182, 317, 84728, 198733]   # the JAX planner, CPU
# GAT on full-size CiteSeer, seed 0: the JAX package's histograms on the
# CPU, per strategy (FPGA model) and on the row-CSR route (CHEAP, csr_rmax
# = A's longest row, 541)
REF_GAT_CI_HIST = {"dynamic": [54837, 268, 85091, 0],
                   "s1": [0, 96932, 43264, 0], "s2": [0, 4, 140192, 0],
                   "gemm": [0, 140196, 0, 0]}
REF_GAT_CI_CSR_HIST = [54837, 4, 84782, 573]
# tile_nnz launches in the GAT windows when attention_adjacency counted
# alpha with a tile_nnz launch of its own per head (the five inferences of
# the strategy window; the two of the CSR window), from chip_smoke.py on an
# NVIDIA H100 80GB HBM3, 700 W.  The edge_softmax kernel now counts alpha
# itself: 4 launches fewer per inference.
UNFUSED_GAT_TILE_NNZ = 130
UNFUSED_GAT_CSR_TILE_NNZ = 46
FLIP_DIST = 1e-6      # a support flip further than this from the threshold
BF16_ALPHA_TOL = 2.0 ** -8   # one bf16 step at alpha in [0.5, 1), so at
                      # least one step of every alpha <= 1

RECORDS: list = []


def record(kind: str, **fields) -> dict:
    rec = {"record": kind, **fields}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)
    return rec


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` per call, by CUDA events, after a warm-up
    call; repeats enough calls to fill about ``target_ms``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = max(1, min(50, int(target_ms / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32) -> tuple:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import repro_torch.kernels as K
    from repro_torch.core import (analyzer, dynasparse, formats, profiler,
                                  runtime)
    from repro_torch.core.ir import KernelType
    from repro_torch.core.perf_model import (Format, FPGACostModel,
                                             Primitive, TPUCostModel)
    from repro_torch.kernels import build, ops
    from repro_torch.models import gnn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    record("env", torch=torch.__version__, cuda=torch.version.cuda,
           device=torch.cuda.get_device_name(0), card=card)
    t0 = time.perf_counter()
    build_s = build.build_all()
    record("build", seconds=build_s, wall=time.perf_counter() - t0)

    # ---------------- main-path bundle: SAGE on full-size CiteSeer --------
    t0 = time.perf_counter()
    sage = gnn.build_dense("sage", "CI", scale=1.0, device=dev)
    record("bundle", model="sage", dataset="CI",
           vertices=sage.graph.spec.n_vertices, features=sage.graph.spec.f_in,
           kernels=[(k.name, k.block_dims) for k in sage.compiled.graph.kernels],
           seconds=time.perf_counter() - t0)
    A, H0 = sage.tensors["A_mean"], sage.tensors["H0"]
    W1 = sage.tensors["Wself1"]
    last = sage.compiled.graph.kernels[-1].out

    def oracle(b, model):
        t = {k: v.double() for k, v in b.tensors.items()}
        if model == "sage":
            h = torch.relu(t["A_mean"] @ t["H0"] @ t["Wneigh1"]
                           + t["H0"] @ t["Wself1"])
            return t["A_mean"] @ h @ t["Wneigh2"] + h @ t["Wself2"]
        h = torch.relu(t["A"] @ (t["H0"] @ t["W1"]))
        return t["A"] @ (h @ t["W2"])

    def close(got, want, tol):
        return bool(torch.allclose(got.double(), want.double(), atol=tol,
                                   rtol=tol))

    kernels_line = {}

    def agree(got, want, tol):
        """(max|err|, ok): exact for integer results, else allclose."""
        err = float((got.double() - want.to(got.device).double()).abs().max())
        if not got.is_floating_point():
            return err, bool(torch.equal(got, want.to(got.device)))
        return err, close(got, want.to(got.device), tol)

    def kernel_entry(name, source, replaces, fn, plain, lib, work, ok_err,
                     tol=TOL, peak=PEAK_FP32, line=True, units="fma",
                     line_name=None, lib_call=None, launches=None,
                     compare=None):
        """Check, time and record one kernel.  ``launches`` is its count
        on the main path where that has run; the kernels line's entries get
        theirs when every path has run (None in their ``kernel`` record).
        ``compare(got, want, tol)`` -> (max|err|, ok) replaces ``agree``."""
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err, ok = (compare or agree)(got, want, tol)
        check(ok and ok_err(got, want),
              f"{name}: kernel disagrees with its plain version "
              f"(max|err|={err}, tol={tol})")
        flops, nbytes = work
        b_ms, b_by = bound(flops, nbytes, peak)
        entry = {"name": name, "route": "cuda", "units": units,
                 "source": source,
                 "replaces": replaces, "launches": launches,
                 "max_abs_err": err,
                 "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None if lib is None else cuda_ms(torch, lib)}
        if lib_call is not None:
            entry["library_call"] = lib_call
        if line:      # under line_name, with the case it was timed on
            kernels_line[line_name or name] = (
                {**entry, "name": line_name, "timed_on": name}
                if line_name else entry)
        # device time of everything the wrapper launches, per call: at
        # small shapes the event time above is the host's (its torch ops
        # and launches), not the card's
        dev = profile_device(torch, fn, n=5)
        # the record's route names the compute units (tensor-core mma, FP32
        # fma, or simt for integer work); the kernels line's route is the
        # language
        return record("kernel", **{**entry, "route": units},
                      device_ms=dev["device_busy_ms"],
                      device_ops=dev["top_device_ops"][:4],
                      profile_windows=dev["windows"],
                      profile_complete=dev["complete"],
                      flops=flops, bytes=nbytes, tol=tol,
                      in_kernels_line=line)

    def small_checks(name, fn_pairs, tol=TOL, compare=None):
        for label, fn, plain in fn_pairs:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err, ok = (compare or agree)(got, want, tol)
            check(ok, f"{name} {label}: max|err|={err} (tol {tol})")
            record("kernel_case", kernel=name, case=label, max_abs_err=err,
                   tol=tol)

    # ---------------- phase 2: each kernel against its plain version ------
    Ap = K.dispatch.pad_to(A, 16, 16).contiguous()           # (3328, 3328)
    Hp = K.dispatch.pad_to(H0, 16, 16).contiguous()          # (3328, 3712)
    W1p = K.dispatch.pad_to(W1, 16, 16).contiguous()         # (3712, 16)
    mm, kk = Ap.shape
    nn = Hp.shape[1]
    dense_lib = lambda: torch.matmul(Ap, Hp)                  # noqa: E731

    # gemm: the gemm strategy's Aggregate product (bound by operations),
    # then the 16-wide products the path also launches (bound by x's bytes)
    def mm_work(x, y):
        (m_, k_), n_ = x.shape, y.shape[1]
        return 2.0 * m_ * k_ * n_, 4.0 * (m_ * k_ + k_ * n_ + m_ * n_)

    kernel_entry(
        "gemm", "src/repro_torch/kernels/csrc/gemm.cu",
        "src/repro/kernels/gemm.py:37",
        lambda: K.gemm.gemm(Ap, Hp), lambda: K.gemm.gemm_plain(Ap, Hp),
        dense_lib, mm_work(Ap, Hp), lambda g, w: True)
    tf = {k_: v.float() for k_, v in sage.tensors.items()}
    H1 = torch.relu(tf["A_mean"] @ tf["H0"] @ tf["Wneigh1"]
                    + tf["H0"] @ tf["Wself1"])
    H1p = K.dispatch.pad_to(H1, 16, 16).contiguous()         # (3328, 16)
    for label, x_, y_ in (("update Hp @ W1p 3328x3712x16", Hp, W1p),
                          ("A @ H1 3328x3328x16", Ap, H1p)):
        kernel_entry(
            f"gemm ({label})", "src/repro_torch/kernels/csrc/gemm.cu",
            "src/repro/kernels/gemm.py:37",
            lambda x_=x_, y_=y_: K.gemm.gemm(x_, y_),
            lambda x_=x_, y_=y_: K.gemm.gemm_plain(x_, y_),
            lambda x_=x_, y_=y_: torch.matmul(x_, y_), mm_work(x_, y_),
            lambda g, w: True, line=False)
    # one k-block of all-GEMM codes makes each dispatch output one fmaf
    # chain over k from 0, then 0 + chain: gemm's value bit for bit
    one_kb = torch.ones((mm // 64, nn // 16, 1), dtype=torch.int32,
                        device=dev)
    got_g = K.gemm.gemm(Ap, Hp)
    got_d = K.dispatch.block_matmul(Ap, Hp, one_kb, (64, kk, 16))
    torch.cuda.synchronize()
    g_bitwise = bool(torch.equal(got_g, got_d))
    record("gemm_vs_dispatch", block=[64, kk, 16], codes="all GEMM",
           bitwise=g_bitwise,
           max_abs_diff=float((got_g - got_d).abs().max()))
    check(g_bitwise, "gemm != one-k-block all-GEMM dispatch")
    del got_g, got_d
    small_checks("gemm", [
        ("update 3328x3712x16", lambda: K.gemm.gemm(Hp, W1p),
         lambda: K.gemm.gemm_plain(Hp, W1p)),
        ("1552x80x1552 (128 tile, overhang)",
         lambda: K.gemm.gemm(Ap[:1552, :80].contiguous(),
                             Hp[:80, :1552].contiguous()),
         lambda: K.gemm.gemm_plain(Ap[:1552, :80], Hp[:80, :1552])),
        ("784x48x784 (16 tile)",
         lambda: K.gemm.gemm(Ap[:784, :48].contiguous(),
                             Hp[:48, :784].contiguous()),
         lambda: K.gemm.gemm_plain(Ap[:784, :48], Hp[:48, :784])),
        ("16x16x16", lambda: K.gemm.gemm(Ap[:16, :16].contiguous(),
                                          Hp[:16, :16].contiguous()),
         lambda: K.gemm.gemm_plain(Ap[:16, :16], Hp[:16, :16]))])

    # spdmm: the s1/s2 strategies' Aggregate product over Block-CSR(A)
    # (the wide route), then (after the main path, which counts their
    # launches) the narrow products s2 also runs over Block-CSR: an Update,
    # Block-CSR(H0) @ W, and A_mean @ H1 (the warp route).  The library
    # yardstick is the fastest single PyTorch call of the same product.
    def sparse_library(label, x, y, padded=None):
        """The fastest of ``torch.sparse.mm`` of ``x`` in 16 x 16 BSR, of
        ``x`` in CSR, and dense ``torch.matmul``, by ``y`` (and, given
        ``padded = (xp, yp)``, CSR ``torch.sparse.mm`` of the operands
        padded to 16-multiples): its function and name.  Every candidate's
        time (None where refused) is recorded."""
        layouts = [("torch.sparse.mm(to_sparse_bsr((16, 16)))",
                    torch.sparse.mm, lambda: x.to_sparse_bsr((16, 16)), y),
                   ("torch.sparse.mm(to_sparse_csr())", torch.sparse.mm,
                    x.to_sparse_csr, y),
                   ("torch.matmul(dense)", torch.matmul, lambda: x, y)]
        if padded is not None:
            layouts.append(("torch.sparse.mm(to_sparse_csr()), padded "
                            f"{tuple(padded[0].shape)} x "
                            f"{tuple(padded[1].shape)}", torch.sparse.mm,
                            padded[0].to_sparse_csr, padded[1]))
        fns, times = {}, {}
        for call, op, layout, rhs in layouts:
            try:
                fns[call] = lambda op=op, xs=layout(), rhs=rhs: op(xs, rhs)
                times[call] = cuda_ms(torch, fns[call])
            except (RuntimeError, NotImplementedError, ValueError) as e:
                times[call] = None
                record("library_refused", case=label, call=call,
                       error=str(e)[:200])
        best = min((t, c) for c, t in times.items() if t is not None)[1]
        record("library_calls", case=label, ms=times, fastest=best)
        return fns[best], best

    def spdmm_work(b, n):
        """(flops, bytes) of Block-CSR ``b`` @ a dense (Kb*tk, n): the
        nonzero tiles' FMAs; their payload, indices and the y rows they
        select read once, the output written once."""
        tm, tk = b.tile
        nz = int(b.counts.sum())
        valid = (torch.arange(b.col_idx.shape[1], device=dev)[None, :]
                 < b.counts[:, None])
        used = int(torch.unique(b.col_idx[valid]).numel())
        rows = b.col_idx.shape[0] * tm
        return (2.0 * nz * tm * tk * n,
                4.0 * (nz * tm * tk + nz + b.counts.numel() + used * tk * n
                       + rows * n))

    xb = formats.dense_to_bcsr(Ap, (16, 16))
    nzt = int(xb.counts.sum())
    sp_lib, sp_call = sparse_library("A @ H0", Ap, Hp)
    kernel_entry(
        "spdmm", "src/repro_torch/kernels/csrc/spdmm.cu",
        "src/repro/kernels/spdmm.py:50",
        lambda: K.spdmm.spdmm(xb, Hp), lambda: K.spdmm.spdmm_plain(xb, Hp),
        sp_lib, spdmm_work(xb, nn), lambda g, w: True, lib_call=sp_call)
    hb = formats.dense_to_bcsr(Hp, (16, 16))
    zb = formats.dense_to_bcsr(torch.zeros_like(Ap), (16, 16))
    small_checks("spdmm", [
        ("update Block-CSR(H0) x W", lambda: K.spdmm.spdmm(hb, W1p),
         lambda: K.spdmm.spdmm_plain(hb, W1p)),
        ("empty lhs", lambda: K.spdmm.spdmm(zb, Hp),
         lambda: K.spdmm.spdmm_plain(zb, Hp)),
        ("sparse_rhs", lambda: ops.spdmm(W1p.T, Hp.T, tile=(16, 16), bn=16,
                                         sparse_rhs=True),
         lambda: (Hp @ W1p).T)])

    # spmm + plan_intersection: the SPMM primitive on A x H0 (16x16 tiles)
    yb = formats.dense_to_bcsc(Hp, (16, 16))
    plan = K.spmm.plan_intersection(xb, yb)
    xb_h = formats.BlockCSRMatrix(xb.col_idx.cpu(), xb.counts.cpu(),
                                  xb.blocks[:, :0].cpu(), xb.shape, xb.tile)
    yb_h = formats.BlockCSCMatrix(yb.row_idx.cpu(), yb.counts.cpu(),
                                  yb.blocks[:, :0].cpu(), yb.shape, yb.tile)
    plan_h = K.spmm.plan_intersection(xb_h, yb_h)
    for a, b_ in zip(plan, plan_h):
        check(torch.equal(a.cpu(), b_), "plan_intersection: device slots "
              "differ from the host's")
    steps = int(plan.counts.sum())
    record("plan_intersection", exact=True, steps=steps,
           shape=list(plan.xpos.shape))
    kernel_entry(
        "spmm", "src/repro_torch/kernels/csrc/spmm.cu",
        "src/repro/kernels/spmm.py:110",
        lambda: K.spmm.spmm(xb, yb, plan),
        lambda: K.spmm.spmm_plain(xb, yb, plan), sp_lib,
        (2.0 * steps * 16 ** 3,
         4.0 * (nzt * 256 + int(yb.counts.sum()) * 256 + 2 * steps
                + plan.counts.numel() + mm * nn)),
        lambda g, w: True, lib_call=sp_call)
    # each output of spdmm and spmm is one fmaf chain over the nonzero
    # tiles (pairs), k ascending, from 0: gemm's value bit for bit
    for label, got_fn, want_fn in (
            ("spdmm A @ H0", lambda: K.spdmm.spdmm(xb, Hp),
             lambda: K.gemm.gemm(Ap, Hp)),
            ("spmm A x H0", lambda: K.spmm.spmm(xb, yb, plan),
             lambda: K.gemm.gemm(Ap, Hp)),
            ("spdmm update Block-CSR(Hp) @ W1p",
             lambda: K.spdmm.spdmm(hb, W1p), lambda: K.gemm.gemm(Hp, W1p)),
            ("spdmm A @ H1", lambda: K.spdmm.spdmm(xb, H1p),
             lambda: K.gemm.gemm(Ap, H1p))):
        got_s, got_g = got_fn(), want_fn()
        torch.cuda.synchronize()
        same = bool(torch.equal(got_s, got_g))
        record("sparse_vs_gemm", case=label, bitwise=same,
               max_abs_diff=float((got_s - got_g).abs().max()))
        check(same, f"{label}: not bitwise equal to gemm")
    del got_s, got_g
    zc = formats.dense_to_bcsc(torch.zeros_like(Hp), (16, 16))
    zplan = K.spmm.plan_intersection(xb, zc)
    small_checks("spmm", [
        ("empty rhs", lambda: K.spmm.spmm(xb, zc, zplan),
         lambda: K.spmm.spmm_plain(xb, zc, zplan)),
        ("32x32 tiles", lambda: ops.spmm(Ap[:512, :512], Hp[:512, :64],
                                         tile=(32, 32)),
         lambda: Ap[:512, :512] @ Hp[:512, :64])])

    # csr_spmm: the CSR phase's Aggregate product, ELL(A, rmax=576)
    rmax = 576
    ell = formats.dense_to_ell(A, rmax)
    capped = torch.clamp(ell.row_counts, max=rmax)
    nnz = int(capped.sum())
    valid = torch.arange(rmax, device=dev)[None, :] < capped[:, None]
    uniq = int(torch.unique(ell.cols[valid]).numel())
    H1c = H1.contiguous()                       # (3327, 16), N2's input
    # each output is one fmaf chain over its row's slots (ascending
    # columns) from 0: gemm's value bit for bit, at N1 and N2
    for label, y_, yp_ in (("N1 ELL(A) @ H0", H0, Hp),
                           ("N2 ELL(A) @ H1", H1c, H1p)):
        got_c = K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y_)
        got_g = K.gemm.gemm(Ap, yp_)[:A.shape[0], :y_.shape[1]]
        torch.cuda.synchronize()
        same = bool(torch.equal(got_c, got_g))
        record("csr_vs_gemm", case=label, rmax=rmax, bitwise=same,
               max_abs_diff=float((got_c - got_g).abs().max()))
        check(same, f"csr_spmm {label}: not bitwise equal to gemm")
    del got_c, got_g
    z_ell = formats.dense_to_ell(torch.zeros_like(A), 0)
    narrow = H0[:, :16].contiguous()          # the second Aggregate's width
    # a row of 600 slots beside 1 % rows, at odd widths
    hrng = np.random.default_rng(5)
    hub = torch.from_numpy(hrng.normal(size=(700, 1500)).astype(np.float32))
    hmask = torch.from_numpy(hrng.random((700, 1500)) < 0.01)
    hmask[5] = False
    hmask[5, torch.from_numpy(hrng.permutation(1500)[:600])] = True
    hub = (hub * hmask).to(dev)
    h_ell = formats.dense_to_ell(hub, 640)
    hy = torch.from_numpy(hrng.normal(size=(1500, 3703)).astype(
        np.float32)).to(dev)
    ell_b = formats.ELLMatrix(ell.values.bfloat16(), ell.cols,
                              ell.row_counts, ell.shape)
    kept = torch.full((A.shape[0], 16), 7.0, device=dev)
    off = torch.zeros((), dtype=torch.int32, device=dev)
    wide = torch.zeros((A.shape[0] + 8, 40), device=dev)

    def csr_k(e, y_, **kw):
        return K.csr_spmm.csr_spmm(e.values, e.cols, e.row_counts, y_, **kw)

    def csr_p(e, y_, **kw):
        return K.csr_spmm.csr_spmm_plain(e.values, e.cols, e.row_counts, y_,
                                         **kw)

    small_checks("csr_spmm", [
        ("ELL(A) x (3327, 16)", lambda: ops.csr_spmm(A, narrow, rmax=rmax),
         lambda: A @ narrow),
        ("rmax 0", lambda: ops.csr_spmm(z_ell, narrow),
         lambda: torch.zeros((A.shape[0], 16), device=dev)),
        *[(f"600-slot row, width {w}", lambda w=w: csr_k(h_ell, hy[:, :w]
                                                          .contiguous()),
           lambda w=w: csr_p(h_ell, hy[:, :w].contiguous()))
          for w in (1, 17, 3703)],
        ("run = 0 leaves out", lambda: csr_k(ell, narrow, out=kept, run=off),
         lambda: torch.full((A.shape[0], 16), 7.0, device=dev)),
        ("ldo 40 > n 16", lambda: csr_k(ell, narrow, out=wide)[
            :A.shape[0], :16], lambda: csr_p(ell, narrow))])
    small_checks("csr_spmm", [
        ("bf16 ELL(A) @ H0", lambda: csr_k(ell_b, H0.bfloat16()),
         lambda: csr_p(ell_b, H0.bfloat16())),
        ("bf16 ELL(A) @ H1", lambda: csr_k(ell_b, H1c.bfloat16()),
         lambda: csr_p(ell_b, H1c.bfloat16()))], tol=BF16_TOL)
    check(not wide[:, 16:].any() and not wide[A.shape[0]:].any(),
          "csr_spmm wrote outside [:m, :n] of a wider buffer")
    del hub, hy, ell_b, wide

    # dispatch: random code grids at the main path's block shapes, then the
    # planner's own grid for the first Aggregate (timed)
    rng = np.random.default_rng(0)

    def rand_codes(I, J, Kb):
        return torch.from_numpy(rng.integers(0, 4, size=(I, J, Kb))
                                .astype(np.int32)).to(dev)

    cases = []
    for blk, (x, y), kind in (
            ((64, 64, 16), (A, H0), "random"),
            ((32, 32, 16), (A, H0), "random"),
            ((16, 16, 16), (H0, W1), "random"),
            ((64, 64, 16), (torch.zeros_like(A), H0), "random"),
            ((128, 48, 256), (A, H0), "random"),
            ((256, 64, 128), (A, H0), "random"),
            ((256, 48, 256), (A, H0), "random"),
            ((64, 64, 16), (A, H0), "all-SKIP")):
        I = -(-x.shape[0] // blk[0])
        Kb = -(-x.shape[1] // blk[1])
        J = -(-y.shape[1] // blk[2])
        c = (rand_codes(I, J, Kb) if kind == "random" else
             torch.zeros((I, J, Kb), dtype=torch.int32, device=dev))
        cases.append((f"{kind} codes {blk} {tuple(x.shape)}x{tuple(y.shape)}",
                      lambda x=x, y=y, c=c, blk=blk:
                      K.dispatch.block_matmul(x, y, c, blk),
                      lambda x=x, y=y, c=c, blk=blk:
                      K.dispatch.block_matmul_plain(x, y, c, blk)))
    small_checks("dispatch", cases)
    blk = sage.compiled.graph.kernels[0].block_dims
    dens_a = profiler.block_density(A, blk[:2])
    dens_h = profiler.block_density(H0, blk[1:])
    codes = analyzer.plan_codes("dynamic", dens_a, dens_h, FPGACostModel())
    kernel_entry(
        "dispatch", "src/repro_torch/kernels/csrc/dispatch.cu",
        "src/repro/core/dynasparse.py:239 (lax.switch over gemm.py:47, "
        "spdmm.py:92, spmm.py:154)",
        lambda: K.dispatch.block_matmul(A, H0, codes, blk),
        lambda: K.dispatch.block_matmul_plain(A, H0, codes, blk),
        lambda: torch.matmul(A, H0),
        dispatch_work(torch, K, A, H0, codes, blk),
        lambda g, w: bool(torch.equal(g, w)))
    record("dispatch_codes", case="A_mean @ H0", block=list(blk),
           histogram=torch.bincount(codes.flatten().long(),
                                    minlength=4).tolist(),
           launch=dataclasses.asdict(K.dispatch.fma_launch(
               codes.shape[0] * blk[0], codes.shape[1], blk)))
    # the Updates' block (16, 16, 16), on the planner's grid for H0 @ Wself1
    ublk = next(k_.block_dims for k_ in sage.compiled.graph.kernels
                if k_.rhs == "Wself1")
    ucodes = analyzer.plan_codes(
        "dynamic", profiler.block_density(H0, ublk[:2]),
        profiler.block_density(W1, ublk[1:]), FPGACostModel())
    kernel_entry(
        f"dispatch (update H0 @ Wself1, {ublk})",
        "src/repro_torch/kernels/csrc/dispatch.cu",
        "src/repro/core/dynasparse.py:239",
        lambda: K.dispatch.block_matmul(H0, W1, ucodes, ublk),
        lambda: K.dispatch.block_matmul_plain(H0, W1, ucodes, ublk),
        lambda: torch.matmul(H0, W1),
        dispatch_work(torch, K, H0, W1, ucodes, ublk),
        lambda g, w: bool(torch.equal(g, w)), line=False)
    record("dispatch_codes", case="update H0 @ Wself1", block=list(ublk),
           histogram=torch.bincount(ucodes.flatten().long(),
                                    minlength=4).tolist(),
           launch=dataclasses.asdict(K.dispatch.fma_launch(
               ucodes.shape[0] * ublk[0], ucodes.shape[1], ublk)))

    # ---------------- phase 3: the main path ------------------------------
    want = oracle(sage, "sage")
    outs, hists = {}, {}
    K.reset_launch_counts()
    for strategy in analyzer.STRATEGIES:
        eng = runtime.DynasparseEngine(strategy=strategy, keep_codes=True)
        out, rep = sage.run(eng)
        outs[strategy], hists[strategy] = out, rep.histogram.tolist()
        if strategy == "dynamic":
            per_kernel_codes = eng.planned_codes
    fused = runtime.FusedModelExecutor(strategy="dynamic", keep_codes=True)
    env, frep = fused.run(sage.compiled, sage.tensors)
    torch.cuda.synchronize()
    main_counts = K.launch_counts()
    spdmm_shapes = dict(K.spdmm.launches_by_shape)
    record("main_path_launches", model="sage", dataset="CI",
           counts=main_counts,
           spdmm_by_shape=[[*k_, v] for k_, v in spdmm_shapes.items()])
    # the narrow spdmm products, each with its launches on the main path
    for label, b_, x_, y_ in (("update Block-CSR(Hp) @ W1p", hb, Hp, W1p),
                              ("A @ H1", xb, Ap, H1p)):
        name = f"spdmm ({label})"
        n_ = spdmm_shapes.get((x_.shape[0], x_.shape[1], y_.shape[1]), 0)
        check(n_ > 0, f"main path never ran {name}")
        lib_, call_ = sparse_library(label, x_, y_)
        kernel_entry(
            name, "src/repro_torch/kernels/csrc/spdmm.cu",
            "src/repro/kernels/spdmm.py:50",
            lambda b_=b_, y_=y_: K.spdmm.spdmm(b_, y_),
            lambda b_=b_, y_=y_: K.spdmm.spdmm_plain(b_, y_), lib_,
            spdmm_work(b_, y_.shape[1]), lambda g, w: True, line=False,
            lib_call=call_, launches=n_)
    for name in ("dispatch", "gemm", "spdmm"):
        check(main_counts[name] > 0, f"main path never launched {name}")
    for strategy, out in outs.items():
        err = float((out.double() - want).abs().max())
        check(close(out, want, MODEL_TOL), f"sage {strategy} vs float64 "
              f"oracle: max|err|={err}")
        record("strategy", model="sage", strategy=strategy,
               histogram=hists[strategy], max_abs_err_vs_f64=err)
    bitwise = bool(torch.equal(env[last], outs["dynamic"]))
    check(bitwise, "fused != per-kernel (sage dynamic)")
    h = hists["dynamic"]
    check(h[1] > 0 and h[2] > 0 and h[3] > 0,
          f"dynamic histogram {h} does not run GEMM, SPDMM and SPMM")
    # the first kernel's inputs are graph inputs: its grid must equal the
    # planner's on the host
    host_codes = analyzer.plan_codes(
        "dynamic", profiler.block_density(A.cpu(), blk[:2]),
        profiler.block_density(H0.cpu(), blk[1:]), FPGACostModel())
    first = sage.compiled.graph.kernels[0].out
    check(np.array_equal(per_kernel_codes[first], host_codes.numpy()),
          "first kernel's device codes differ from the host planner's")
    for name, c in per_kernel_codes.items():
        check(np.array_equal(c, fused.planned_codes[name]),
              f"fused codes differ from per-kernel codes at {name}")
    record("main_path", model="sage", dataset="CI", histogram_dynamic=h,
           reference_histogram_dynamic=REF_SAGE_CI_HIST,
           equal_to_reference=h == REF_SAGE_CI_HIST,
           per_kernel_histograms={k.name: r.histogram.tolist() for k, r in
                                  zip(sage.compiled.graph.kernels,
                                      frep.kernels)},
           fused_bitwise_per_kernel=bitwise, first_kernel_codes_exact=True)

    # ---------------- phase 4: the row-CSR path ---------------------------
    cheap = dataclasses.replace(TPUCostModel(), eff_transform=1.0,
                                transform_overhead_s=0.0)
    K.reset_launch_counts()
    eng = runtime.DynasparseEngine(model=cheap, csr_rmax=rmax,
                                   keep_codes=True)
    out_csr, _ = sage.run(eng)
    fused_csr = runtime.FusedModelExecutor(model=cheap, csr_rmax=rmax,
                                           keep_codes=True)
    env_csr, _ = fused_csr.run(sage.compiled, sage.tensors)
    torch.cuda.synchronize()
    csr_counts = K.launch_counts()
    csr_shapes = dict(K.csr_spmm.launches_by_shape)
    record("csr_path_launches", counts=csr_counts,
           csr_spmm_by_shape=[[*k_, v] for k_, v in csr_shapes.items()])
    check(csr_counts["csr_spmm"] > 0, "CSR path never launched csr_spmm")
    fmts = {k: int(v) for k, v in eng.planned_formats.items()}
    check(fmts["N1"] == Format.CSR and fmts["N2"] == Format.CSR,
          f"CSR not executed on N1/N2: {fmts}")
    err = float((out_csr.double() - outs["dynamic"].double()).abs().max())
    check(close(out_csr, outs["dynamic"], MODEL_TOL),
          f"CSR path vs block path: max|err|={err}")
    csr_bitwise = bool(torch.equal(env_csr[last], out_csr))
    check(csr_bitwise, "fused != per-kernel (CSR path)")
    record("csr_path", formats=fmts,
           fused_formats={k: int(v) for k, v in
                          fused_csr.planned_formats.items()},
           max_abs_err_vs_block_path=err, fused_bitwise_per_kernel=True)
    # csr_spmm at its two shapes of the CSR phase, N1 (ELL(A) @ H0, in the
    # kernels line) and N2 (ELL(A) @ H1, 16 wide)
    for label, y_, yp_, line in (("N1 ELL(A) @ H0", H0, Hp, True),
                                 ("N2 ELL(A) @ H1", H1c, H1p, False)):
        n_ = csr_shapes.get((A.shape[0], y_.shape[1]), 0)
        check(n_ > 0, f"CSR phase never ran csr_spmm {label}")
        lib_, call_ = sparse_library(f"csr_spmm {label}", A, y_,
                                     padded=(Ap, yp_))
        w_ = y_.shape[1]
        kernel_entry(
            "csr_spmm" if line else f"csr_spmm ({label})",
            "src/repro_torch/kernels/csrc/csr_spmm.cu",
            "src/repro/kernels/csr_spmm.py:43",
            lambda y_=y_: csr_k(ell, y_), lambda y_=y_: csr_p(ell, y_), lib_,
            (2.0 * nnz * w_,
             8.0 * nnz + 4.0 * (A.shape[0] + uniq * w_ + A.shape[0] * w_)),
            lambda g, w: True, line=line, lib_call=call_, launches=n_)
    # why CSR torch.sparse.mm runs faster on the padded operands: the same
    # call with only y's rows padded to 16-byte multiples (3712 columns)
    a_csr, ap_csr = A.to_sparse_csr(), Ap.to_sparse_csr()
    h_cols = K.dispatch.pad_to(H0, 1, 16).contiguous()
    record("csr_library_alignment", card=card, ms={
        "A (3327, 3327) @ H0 (3327, 3703)": cuda_ms(
            torch, lambda: torch.sparse.mm(a_csr, H0)),
        "A (3327, 3327) @ H0 columns padded (3327, 3712)": cuda_ms(
            torch, lambda: torch.sparse.mm(a_csr, h_cols)),
        "A padded (3328, 3328) @ H0 padded (3328, 3712)": cuda_ms(
            torch, lambda: torch.sparse.mm(ap_csr, Hp))})
    del a_csr, ap_csr, h_cols
    # one format-aware inference on the device, per kernel and fused: the
    # ELL conversions (formats.dense_to_ell) beside the csr_spmm launches
    record("profile", engine="per-kernel", path="csr", card=card,
           **profile_device(torch, lambda: sage.run(eng), top=20))
    record("profile", engine="fused", path="csr", card=card,
           **profile_device(torch, lambda: fused_csr.run(sage.compiled,
                                                         sage.tensors),
                            top=20))

    # ---------------- phase 4b: bf16 on the static and CSR routes ---------
    brng = np.random.default_rng(6)

    def small_ints(m_, n_, density):
        """bf16 integers in [-4, 4] on a sparse mask: every product and
        partial sum is exact in float32, so the card and the plain route
        agree exactly whatever the order of their sums (the executor casts
        its float32 sums to bf16), and a stale tile shows."""
        v = brng.integers(-4, 5, size=(m_, n_)) * (
            brng.random((m_, n_)) < density)
        return torch.from_numpy(v.astype(np.float32)).to(dev).bfloat16()

    bx, bw = small_ints(3327, 3703, 0.01), small_ints(3703, 16, 0.5)
    ba, bh = small_ints(3327, 3327, 0.002), small_ints(3327, 16, 0.5)
    bblk = (64, 64, 16)                 # bm, bn in dispatch.BLOCK_EDGES
    one = torch.ones((), dtype=torch.int32, device=dev)
    K.reset_launch_counts()
    cases = []
    for strategy in ("gemm", "s1", "s2"):
        kw = dict(strategy=strategy, block=bblk,
                  kernel_type=KernelType.AGGREGATE)
        cases.append((f"bf16 {strategy} H0-shaped @ W, {bblk}",
                      lambda kw=kw: dynasparse.dynasparse_matmul(
                          bx, bw, **kw).out,
                      lambda kw=kw: dynasparse.dynasparse_matmul(
                          bx.cpu(), bw.cpu(), **kw).out))
    kw = dict(block=bblk, fmt=one, format_aware=True, csr_rmax=rmax)
    cases.append(("bf16 format-aware CSR A-shaped @ H1-shaped",
                  lambda: dynasparse.dynasparse_matmul(ba, bh, **kw).out,
                  lambda: dynasparse.dynasparse_matmul(
                      ba.cpu(), bh.cpu(), **{**kw, "fmt": one.cpu()}).out))
    small_checks("dynasparse_matmul", cases, tol=DISPATCH_BF16_TOL)
    bf16_counts = K.launch_counts()
    record("bf16_routes_launches", counts=bf16_counts)
    check(bf16_counts["dispatch"] >= 4 and bf16_counts["csr_spmm"] >= 1
          and bf16_counts["gemm"] == bf16_counts["spdmm"] == 0,
          f"bf16 static/CSR routes launched {bf16_counts}")
    del bx, bw, ba, bh

    # ---------------- phase 5: GCN on full-size CiteSeer ------------------
    gcn = gnn.build_dense("gcn", "CI", scale=1.0, device=dev)
    K.reset_launch_counts()
    g_out, g_rep = gcn.run(runtime.DynasparseEngine())
    g_env, _ = runtime.FusedModelExecutor().run(gcn.compiled, gcn.tensors)
    torch.cuda.synchronize()
    gcn_counts = K.launch_counts()
    check(gcn_counts["dispatch"] > 0, "GCN path never launched dispatch")
    g_err = float((g_out.double() - oracle(gcn, "gcn")).abs().max())
    check(close(g_out, oracle(gcn, "gcn"), MODEL_TOL),
          f"gcn vs float64 oracle: max|err|={g_err}")
    g_last = gcn.compiled.graph.kernels[-1].out
    check(bool(torch.equal(g_env[g_last], g_out)),
          "fused != per-kernel (gcn)")
    record("gcn_path", histogram=g_rep.histogram.tolist(),
           max_abs_err_vs_f64=g_err, fused_bitwise_per_kernel=True,
           launches=gcn_counts)

    # ---------------- phase 5b: GAT on full-size CiteSeer -----------------
    gat_counts = gat_phase(torch, np, K, dev, card, kernel_entry,
                           small_checks, close)

    # ---------------- phase 5c: batched graph serving -------------------
    serve_counts = serving_phase(torch, np, K, dev, card, kernel_entry,
                                 small_checks, close)

    # ---------------- phase 5d: continuous serving -----------------------
    continuous_phase(torch, np, K, dev, card)

    # ---------------- phase 5e: mini-batch serving -----------------------
    minibatch_phase(torch, np, K, dev, card)

    # ---------------- phase 5f: the cost-model simulator ------------------
    simulator_phase(torch, np, K, dev, card, A, H0)

    # ---------------- phase 5g: multi-device wave dispatch ----------------
    sharded_phase(torch, np, K, dev, card)

    # ---------------- phase 6: the per-primitive path (ops.matmul) --------
    K.reset_launch_counts()
    for prim in (Primitive.GEMM, Primitive.SPDMM, Primitive.SPMM):
        got = ops.matmul(A, H0, prim, tile=(16, 16))
        e = float((got.double() - A.double() @ H0.double()).abs().max())
        check(close(got, A.double() @ H0.double(), TOL),
              f"ops.matmul {prim.name}: max|err|={e}")
        record("primitive", primitive=prim.name, max_abs_err_vs_f64=e)
    torch.cuda.synchronize()
    prim_counts = K.launch_counts()
    record("primitive_path_launches", counts=prim_counts)
    for name in ("gemm", "spdmm", "spmm"):
        check(prim_counts[name] > 0, f"primitive path never launched {name}")

    # ---------------- times: one inference, per engine --------------------
    for strategy in analyzer.STRATEGIES:
        eng = runtime.DynasparseEngine(strategy=strategy)
        record("wall", model="sage", dataset="CI", engine="per-kernel",
               strategy=strategy,
               median_ms=wall_ms(torch, lambda: sage.run(eng)),
               card=card)
    for collect in (True, False):
        fx = runtime.FusedModelExecutor(collect_report=collect)
        record("wall", model="sage", dataset="CI", engine="fused",
               strategy="dynamic", collect_report=collect,
               median_ms=wall_ms(torch, lambda: fx.run(sage.compiled,
                                                      sage.tensors)),
               card=card)
    K.reset_launch_counts()
    sage.run(runtime.DynasparseEngine())
    record("launches_per_inference", engine="per-kernel", strategy="dynamic",
           counts=K.launch_counts())
    fx = runtime.FusedModelExecutor(collect_report=False)
    record("profile", engine="fused", collect_report=False, card=card,
           **profile_device(torch, lambda: fx.run(sage.compiled,
                                                  sage.tensors)))
    # the s2 (AWB-GCN) strategy per kernel: its six spdmm launches beside
    # the Block-CSR conversions (dense_to_bcsr) that feed them
    s2 = runtime.DynasparseEngine(strategy="s2")
    record("profile", engine="per-kernel", strategy="s2", card=card,
           **profile_device(torch, lambda: sage.run(s2)))

    # ---------------- phases 7-9: the LM paths (llama3.2-1b) --------------
    lm_counts = lm_paths(torch, np, K, dev, card, A, kernel_entry,
                         small_checks)

    # ---------------- phase 10: the LM families --------------------------
    lm_families_phase(torch, np, K, dev, card, kernel_entry)

    # ---------------- phase 11: LM training (llama3.2-1b) ----------------
    train_counts = train_phase(torch, np, K, dev, card, kernel_entry)

    # ---------------- phase 12: the dry run ------------------------------
    padded_counts = dryrun_phase(torch, np, K, dev, card, kernel_entry)

    kernels_line["gemm"]["launches"] = main_counts["gemm"]
    kernels_line["spdmm"]["launches"] = main_counts["spdmm"]
    kernels_line["dispatch"]["launches"] = main_counts["dispatch"]
    kernels_line["csr_spmm"]["launches"] = csr_counts["csr_spmm"]
    kernels_line["spmm"]["launches"] = prim_counts["spmm"]
    kernels_line["tile_nnz"]["launches"] = lm_counts["serve"]["tile_nnz"]
    kernels_line["flash_attention"]["launches"] = \
        lm_counts["score"]["flash_attention"]
    kernels_line[LM_DISPATCH]["launches"] = lm_counts["serve"]["dispatch"]
    kernels_line[LM_FLASH_F32]["launches"] = \
        lm_counts["score_f32"]["flash_attention"]
    kernels_line["dispatch_bwd"]["launches"] = train_counts["dispatch_bwd"]
    kernels_line[BWD_F32]["launches"] = train_counts[BWD_F32]
    kernels_line[FWD_F32]["launches"] = train_counts[FWD_F32]
    kernels_line["edge_softmax"]["launches"] = gat_counts["edge_softmax"]
    kernels_line["tile_nnz_batched"]["launches"] = \
        serve_counts["tile_nnz_batched"]
    kernels_line[PADDED_TILE_NNZ]["launches"] = padded_counts["tile_nnz"]
    check(set(K.launch_counts()) | {LM_DISPATCH, PADDED_TILE_NNZ,
                                    LM_FLASH_F32, BWD_F32, FWD_F32}
          == set(kernels_line)
          and all(e["launches"] > 0 for e in kernels_line.values()),
          f"kernels line incomplete: {sorted(kernels_line)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORDS, indent=1))
    print(card)
    print(json.dumps({"kernels": list(kernels_line.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def gat_phase(torch, np, K, dev, card, kernel_entry, small_checks,
              close) -> dict:
    """Phase 5b: GAT on full-size CiteSeer.  ``edge_softmax`` against its
    plain version on layer 1 head 1's operands in float32 and bf16 (and a
    small case with empty rows), its fused block counts against
    ``tile_nnz`` of the alpha as stored; both engines under every strategy
    in one launch-count window, held to the JAX planner's histograms and a
    float64 oracle; the row-CSR route under CHEAP; one profiled fused
    inference.  Returns the window's launch counts."""
    from repro_torch.core import analyzer, runtime
    from repro_torch.core.ir import KernelType
    from repro_torch.core.perf_model import Format, TPUCostModel
    from repro_torch.models import gnn

    E = K.edge_softmax
    t0 = time.perf_counter()
    gat = gnn.build_dense("gat", "CI", scale=1.0, device=dev)
    cm, tensors = gat.compiled, gat.tensors
    kernels = cm.graph.kernels
    att = next(k for k in kernels if k.kernel_type == KernelType.ATTENTION)
    slope, thr = att.att_slope, att.att_threshold
    record("bundle", model="gat", dataset="CI",
           vertices=gat.graph.spec.n_vertices, features=gat.graph.spec.f_in,
           heads=2, slope=slope, threshold=thr,
           kernels=[(k.name, k.block_dims) for k in kernels],
           seconds=time.perf_counter() - t0)
    last = kernels[-1].out
    heads = [k_.out for k_ in kernels if k_.kernel_type
             == KernelType.ATTENTION]                  # T1h1 ... T2h2

    def flip_report(label, got, want, threshold=thr):
        """Entries zero on one side, nonzero on the other: each within
        FLIP_DIST of the threshold, or the run fails."""
        n_, dist = E.support_flips(got, want, threshold)
        record("attention_flips", case=label, flips=n_,
               max_dist_from_threshold=dist, limit=FLIP_DIST)
        check(dist <= FLIP_DIST, f"{label}: {n_} support flips, one "
              f"{dist} from the threshold")
        return n_

    def alpha_agree(threshold, block):
        """(max|err|, ok) of two ``(alpha, counts)`` over the entries
        neither alpha zeroed alone (a flip at the threshold is reported,
        not an error); the kernel's counts must equal ``tile_nnz`` of its
        own alpha at ``block``, and the plain ones where nothing flipped."""
        def compare(got, want, tol):
            (got, got_c), (want, want_c) = got, want
            same = (got != 0) == (want != 0)
            g_, w_ = torch.where(same, got, 0.0), torch.where(same, want, 0.0)
            err = float((g_.double() - w_.double()).abs().max())
            flips = flip_report(f"edge_softmax vs plain, n={got.shape[0]}, "
                                f"{got.dtype}", got, want, threshold)
            counts_ok = bool(torch.equal(got_c, K.profile.tile_nnz(
                got, block))) and (flips > 0 or bool(torch.equal(got_c,
                                                                   want_c)))
            return err, close(g_, w_, tol) and counts_ok
        return compare

    # the kernel on layer 1 head 1's operands (a warm-up inference makes
    # Z1h1; its launches are outside every window)
    warm, _ = runtime.FusedModelExecutor(keep_intermediates=True).run(
        cm, tensors)
    A, Z = tensors["A"], warm["Z1h1"]
    asrc, adst = tensors["a_src1h1"], tensors["a_dst1h1"]
    del warm
    n, f = Z.shape
    nnz = int(torch.count_nonzero(A))
    ob = (att.scheme.n2, att.scheme.n2)      # the engines' out_block

    def es(a_=A, z_=Z):
        return E.edge_softmax(a_, z_, asrc, adst, slope=slope, threshold=thr,
                              out_block=ob)

    def es_plain(a_=A, z_=Z):
        return E.edge_softmax_plain(a_, z_, asrc, adst, slope=slope,
                                    threshold=thr, out_block=ob)

    (got, got_c), (want, want_c) = es(), es_plain()
    torch.cuda.synchronize()
    n_flips = E.support_flips(got, want, thr)[0]   # reported by the entry
    stored = K.profile.tile_nnz(got, ob)
    check(bool(torch.equal(got_c, stored)), "edge_softmax: fused counts != "
          f"tile_nnz of the alpha as stored at {ob}")
    diff = int((got_c - want_c).abs().sum())
    check(diff == 0 if n_flips == 0 else diff <= n_flips,
          f"edge_softmax: tile counts differ by {diff} ({n_flips} flips)")
    shape = E.edge_launch(n, ob)
    record("edge_softmax_support", case="A @ Z1h1", nnz_kernel=int(
        torch.count_nonzero(got)), nnz_plain=int(torch.count_nonzero(want)),
        support=nnz, flips=n_flips, out_block=list(ob),
        counts_equal_tile_nnz=True, tile_counts_equal=diff == 0,
        route=E.ROUTES[shape.route], launch=dataclasses.asdict(shape),
        alpha_sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest())
    del got, want, got_c, want_c, stored
    counts_bytes = 4.0 * -(-n // ob[0]) * -(-n // ob[1])
    ops_ = 4.0 * n * f + 3.0 * n * n + 4.0 * nnz
    kernel_entry(
        "edge_softmax", "src/repro_torch/kernels/csrc/edge_softmax.cu",
        "src/repro/core/dynasparse.py:311 (jnp attention_adjacency; no "
        "pallas_call)", es, es_plain, None,
        # score, LeakyReLU and compare per element and both projections;
        # subtract, exp, add and divide per support entry.  Bytes: a read
        # once, alpha and its counts written once, z and the vectors read
        # once
        (ops_, 4.0 * (2 * n * n + n * f + 2 * f) + counts_bytes),
        lambda g, w: True, units="simt", compare=alpha_agree(thr, ob),
        lib_call="none: no single PyTorch call computes a thresholded "
                 "masked edge-softmax")
    # bf16 A and Z1h1: alpha in bf16, the arithmetic in float32
    A16, Z16 = A.bfloat16(), Z.bfloat16()
    kernel_entry(
        "edge_softmax (bf16 A and Z1h1)",
        "src/repro_torch/kernels/csrc/edge_softmax.cu",
        "src/repro/core/dynasparse.py:311 (jnp attention_adjacency; no "
        "pallas_call)", lambda: es(A16, Z16), lambda: es_plain(A16, Z16),
        None, (ops_, 2.0 * (2 * n * n + n * f) + 8.0 * f + counts_bytes),
        lambda g, w: g[0].dtype == torch.bfloat16, tol=BF16_ALPHA_TOL,
        line=False, units="simt", compare=alpha_agree(thr, ob),
        lib_call="none")
    del A16, Z16
    rng = np.random.default_rng(7)
    small = [torch.from_numpy(v.astype(np.float32)).to(dev) for v in (
        rng.random((40, 40)) < 0.2, rng.normal(size=(40, 8)),
        rng.normal(size=(8, 1)), rng.normal(size=(8, 1)))]
    small[0][-5:] = 0.0
    for t_ in (0.0, 0.6):
        small_checks("edge_softmax", [(
            f"n=40, five empty rows, threshold {t_}",
            lambda t_=t_: E.edge_softmax(*small, threshold=t_,
                                         out_block=(16, 16)),
            lambda t_=t_: E.edge_softmax_plain(*small, threshold=t_,
                                               out_block=(16, 16)))],
            compare=alpha_agree(t_, (16, 16)))
        got = E.edge_softmax(*small, threshold=t_)[0]
        check(not got[-5:].any() and not torch.isnan(got).any(),
              "edge_softmax: empty rows are not exactly zero")

    # ---- both engines, every strategy, in one window --------------------
    K.reset_launch_counts()
    runs = {}
    for strategy in analyzer.STRATEGIES:
        eng = runtime.DynasparseEngine(strategy=strategy, keep_codes=True)
        env_s, rep = eng.run(cm, tensors)
        runs[strategy] = (env_s, rep.histogram.tolist(), eng.planned_codes)
    fused = runtime.FusedModelExecutor(strategy="dynamic", keep_codes=True)
    f_env, f_rep = fused.run(cm, tensors)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    record("gat_path_launches", model="gat", dataset="CI", counts=counts)
    engines = len(analyzer.STRATEGIES) + 1
    check(counts["edge_softmax"] == 4 * engines,
          f"edge_softmax launched {counts['edge_softmax']} times, expected "
          f"4 per inference in {engines} inferences")
    record("gat_tile_nnz_launches", window="strategies", inferences=engines,
           tile_nnz=counts["tile_nnz"],
           tile_nnz_with_unfused_counts=UNFUSED_GAT_TILE_NNZ)
    check(counts["tile_nnz"] == UNFUSED_GAT_TILE_NNZ - 4 * engines,
          f"GAT window launched tile_nnz {counts['tile_nnz']} times, "
          f"expected {UNFUSED_GAT_TILE_NNZ} - 4 per inference")
    for name in ("edge_softmax", "dispatch", "gemm", "spdmm", "tile_nnz"):
        check(counts[name] > 0, f"GAT path never launched {name}")
    hist = {s_: h_ for s_, (_, h_, _) in runs.items()}
    check(hist == REF_GAT_CI_HIST, f"GAT histograms {hist} != the JAX "
          f"planner's {REF_GAT_CI_HIST}")
    dyn_env, _, dyn_codes = runs["dynamic"]
    bitwise = bool(torch.equal(f_env[last], dyn_env[last]))
    check(bitwise, "fused != per-kernel (gat dynamic)")
    check(f_rep.histogram.tolist() == hist["dynamic"],
          "fused GAT histogram differs from per-kernel")
    for name, c in dyn_codes.items():
        check(np.array_equal(c, fused.planned_codes[name]),
              f"fused codes differ from per-kernel codes at {name}")

    # float64 oracle on each run's own post-threshold support
    t64 = {k_: v.double() for k_, v in tensors.items()}

    def alpha64(a, z, s_, d_):
        s2 = z @ torch.cat([s_, d_], dim=1)
        sc = s2[:, :1] + s2[:, 1:2].T
        sc = torch.where(sc >= 0, sc, slope * sc)
        sup = a != 0
        mx = torch.where(sup, sc, float("-inf")).amax(dim=1, keepdim=True)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        ex = torch.where(sup, torch.exp(sc - mx), 0.0)
        return ex / ex.sum(dim=1, keepdim=True).clamp(min=1e-30)

    def oracle(env_s, label):
        h = t64["H0"]
        for l_ in (1, 2):
            acc = 0.0
            for hd in (1, 2):
                z = h @ t64[f"Wg{l_}h{hd}"]
                al = alpha64(t64["A"], z, t64[f"a_src{l_}h{hd}"],
                             t64[f"a_dst{l_}h{hd}"])
                run_t = env_s[f"T{l_}h{hd}"]
                flip_report(f"{label} T{l_}h{hd} vs float64",
                            run_t, torch.where(al > thr, al, 0.0).float())
                acc = acc + torch.where(run_t != 0, al, 0.0) @ z
            h = torch.relu(acc) if l_ == 1 else acc
        return h

    for strategy, (env_s, h_, _) in runs.items():
        want = oracle(env_s, f"gat {strategy}")
        err = float((env_s[last].double() - want).abs().max())
        check(close(env_s[last], want, MODEL_TOL),
              f"gat {strategy} vs float64 oracle: max|err|={err}")
        record("strategy", model="gat", strategy=strategy, histogram=h_,
               reference_histogram=REF_GAT_CI_HIST[strategy],
               max_abs_err_vs_f64=err,
               attention_nnz={t_: int(torch.count_nonzero(env_s[t_]))
                              for t_ in heads})
    record("gat_path", model="gat", dataset="CI", histograms=hist,
           equal_to_reference=True, fused_bitwise_per_kernel=bitwise,
           per_kernel_histograms={k_.name: r.histogram.tolist() for k_, r in
                                  zip(kernels, f_rep.kernels)})
    del runs, f_env

    # ---- the row-CSR route: ELL of each head's attention matrix ---------
    cheap = dataclasses.replace(TPUCostModel(), eff_transform=1.0,
                                transform_overhead_s=0.0)
    rmax = int((A != 0).sum(dim=1).max())
    K.reset_launch_counts()
    eng = runtime.DynasparseEngine(model=cheap, csr_rmax=rmax,
                                   keep_codes=True)
    c_env, c_rep = eng.run(cm, tensors)
    fused_c = runtime.FusedModelExecutor(model=cheap, csr_rmax=rmax,
                                         keep_codes=True)
    cf_env, _ = fused_c.run(cm, tensors)
    torch.cuda.synchronize()
    csr_counts = K.launch_counts()
    record("gat_csr_path_launches", counts=csr_counts)
    check(csr_counts["csr_spmm"] > 0, "GAT CSR route never launched csr_spmm")
    check(csr_counts["edge_softmax"] == 8, "GAT CSR route launched "
          f"edge_softmax {csr_counts['edge_softmax']} times, expected 8")
    record("gat_tile_nnz_launches", window="csr", inferences=2,
           tile_nnz=csr_counts["tile_nnz"],
           tile_nnz_with_unfused_counts=UNFUSED_GAT_CSR_TILE_NNZ)
    check(csr_counts["tile_nnz"] == UNFUSED_GAT_CSR_TILE_NNZ - 8,
          f"GAT CSR window launched tile_nnz {csr_counts['tile_nnz']} "
          f"times, expected {UNFUSED_GAT_CSR_TILE_NNZ} - 4 per inference")
    aggs = [k_.out for k_ in kernels if k_.kernel_type == KernelType.AGGREGATE]
    fmts = {k_: int(v) for k_, v in eng.planned_formats.items()}
    check(all(fmts[a_] == Format.CSR for a_ in aggs),
          f"CSR not executed on every head Aggregate: {fmts}")
    c_hist = c_rep.histogram.tolist()
    check(c_hist == REF_GAT_CI_CSR_HIST, f"GAT CSR histogram {c_hist} != "
          f"the JAX planner's {REF_GAT_CI_CSR_HIST}")
    c_bitwise = bool(torch.equal(cf_env[last], c_env[last]))
    check(c_bitwise, "fused != per-kernel (gat CSR route)")
    err = float((c_env[last].double() - dyn_env[last].double()).abs().max())
    check(close(c_env[last], dyn_env[last], TOL),
          f"GAT CSR route vs block path: max|err|={err}")
    record("gat_csr_path", rmax=rmax, formats=fmts, histogram=c_hist,
           reference_histogram=REF_GAT_CI_CSR_HIST,
           max_abs_err_vs_block_path=err, fused_bitwise_per_kernel=True)
    del c_env, cf_env, dyn_env

    # ---- times: one inference per engine; one profiled fused inference --
    for strategy in analyzer.STRATEGIES:
        eng = runtime.DynasparseEngine(strategy=strategy)
        record("wall", model="gat", dataset="CI", engine="per-kernel",
               strategy=strategy,
               median_ms=wall_ms(torch, lambda: eng.run(cm, tensors)),
               card=card)
    fx = runtime.FusedModelExecutor(collect_report=False)
    record("wall", model="gat", dataset="CI", engine="fused",
           strategy="dynamic", collect_report=False,
           median_ms=wall_ms(torch, lambda: fx.run(cm, tensors)), card=card)
    record("profile", model="gat", engine="fused", collect_report=False,
           card=card, **profile_device(torch, lambda: fx.run(cm, tensors),
                                       top=15))
    return counts


STREAM_F_IN, STREAM_SIZES, STREAM_SEED = 64, (56, 100, 150), 7
# benchmarks/bench_serving.py:105-106,158-162: the reference's own serving
# stream (hidden 16, 7 classes, weight seed 0; BENCH_serving.json's rows
# serve 16 requests in waves of 4)
STREAM_REQUESTS, STREAM_SLOTS = 16, 4
# SAGE at CiteSeer's widths (data/graphs.py TABLE_VI["CI"]): CiteSeer's
# average degree and feature density (random_requests floors the latter
# at 0.02), sizes up to CiteSeer's 3327 vertices
CI_SIZES, CI_REQUESTS, CI_DEGREE, CI_FEAT = (900, 1800, 3327), 12, 3, 0.0085
CI_F_IN, CI_CLASSES, CI_BUCKETS = 3703, 6, [1024, 2048, 4096]


def serving_phase(torch, np, K, dev, card, kernel_entry, small_checks,
                  close) -> dict:
    """Phase 5c: batched graph serving (``GraphServeEngine.serve``).

    The batched ``tile_nnz`` route against per-slot 2-D launches and its
    plain version; (a) the reference's serving stream through all five
    models under ``dynamic``, SAGE under the static strategies and GCN on
    the row-CSR route: serve == run_naive bitwise, one walk plan per
    bucket, one batched launch per (request input, granularity) per wave
    with no host synchronization inside ``launch_batch``, dummy slots all
    SKIP; (b) SAGE at CiteSeer's widths: bitwise == run_naive, a float64
    oracle per request, per-request histograms, wave walls, copy and
    gather times, device busy and requests/s.  Returns the launch counts
    of (b)'s serve window."""
    import warnings
    from repro_torch.core import runtime
    from repro_torch.core.ir import KernelType
    from repro_torch.core.perf_model import Format, TPUCostModel
    from repro_torch.data import graphs as graph_data
    from repro_torch.serving.graph_engine import (GraphServeEngine,
                                                  random_requests)
    P = K.profile

    # ---- the batched tile_nnz route: exact, per slot and against plain --
    rng = np.random.default_rng(19)
    for b_, m_, n_ in ((1, 100, 130), (3, 700, 1500), (4, 333, 77)):
        x = rng.normal(size=(b_, m_, n_)) * (rng.random((b_, m_, n_)) < 0.05)
        x[b_ // 2] = 0.0                              # a dummy slot
        xt = torch.from_numpy(x.astype(np.float32)).to(dev)
        for tile in ((16, 16), (64, 16), (32, 1)):
            before = P.batched_launches
            got = P.tile_nnz_batched(xt, tile)
            check(P.batched_launches == before + 1,
                  "tile_nnz_batched: not one launch per stack")
            per_slot = torch.stack([P.tile_nnz(xt[i], tile)
                                    for i in range(b_)])
            ok = (bool(torch.equal(got, per_slot)) and bool(torch.equal(
                got, P.tile_nnz_plain(xt, tile))) and not got[b_ // 2].any())
            check(ok, f"tile_nnz_batched ({b_}, {m_}, {n_}) at {tile}: "
                      "counts differ from the per-slot 2-D launches or "
                      "the plain version")
            record("kernel_case", kernel="tile_nnz_batched",
                   case=f"({b_}, {m_}, {n_}) at {tile}, slot {b_ // 2} "
                        "all zero", equal_per_slot_2d=True,
                   equal_plain=True, max_abs_err=0.0, tol=0)
    del xt, got, per_slot

    # ---- (a) the reference's serving stream ------------------------------
    cheap = dataclasses.replace(TPUCostModel(), eff_transform=1.0,
                                transform_overhead_s=0.0)
    reqs = random_requests(STREAM_REQUESTS, f_in=STREAM_F_IN,
                           sizes=STREAM_SIZES, seed=STREAM_SEED)

    def watch(eng, waves):
        """Per-wave checks through the engine's own entry points: the
        batched launches and host synchronizations of each launch_batch,
        and after each finish the dummy slots' codes, the slots' planned
        codes and formats and the report.  Returns the function that puts
        the engine's own entry points back."""
        launch, finish = eng.executor.launch_batch, eng.finish_wave

        def launch_batch(cm, shared, batched, mesh=None):
            flows = runtime.FusedModelExecutor._resolved_flows(cm)
            needed = [n_ for n_, _ in runtime.FusedModelExecutor
                      ._needed_inputs(flows) if n_ in batched]
            before = P.batched_launches
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    pending = launch(cm, shared, batched, mesh=mesh)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = [str(w_.message)[:120] for w_ in caught
                     if "ynchroniz" in str(w_.message)]
            waves.append({"slots": pending.wave_slots,
                          "batched_launches": P.batched_launches - before,
                          "request_inputs": len(needed),
                          "host_syncs": syncs})
            return pending

        def finish_wave(inflight):
            res = finish(inflight)
            rep = eng.last_wave_report
            waves[-1].update(bucket=inflight.bucket, real=rep.wave_real,
                             wall_s=rep.fused_wall_seconds,
                             gather_s=rep.gather_seconds,
                             copy_s=rep.copy_seconds, report=rep)
            if eng.executor.keep_codes:
                waves[-1].update(requests=inflight.wave,
                                 codes=dict(eng.executor.planned_codes),
                                 formats=dict(eng.executor.planned_formats))
                kernels = eng._compiled[inflight.bucket].graph.kernels
                waves[-1]["dummy_all_skip"] = all(
                    not eng.executor.planned_codes[k_.out][rep.wave_real:]
                    .any() for k_ in kernels
                    if k_.kernel_type != KernelType.ATTENTION)
            return res

        eng.executor.launch_batch = launch_batch
        eng.finish_wave = finish_wave

        def unwatch():
            del eng.executor.launch_batch, eng.finish_wave
        return unwatch

    def own_plans(eng, waves):
        """Hold every real slot's planned codes and executed formats to a
        per-request ``DynasparseEngine`` run on the same padded tensors,
        exactly; returns the per-request reports, in wave order."""
        per = runtime.DynasparseEngine(
            strategy=eng.strategy, model=eng.executor.model, n_cc=eng.n_cc,
            keep_codes=True, format_aware=eng.format_aware,
            csr_rmax=eng.csr_rmax)
        reports = []
        for w_ in waves:
            cm = eng._compiled[w_["bucket"]]
            for b_, req in enumerate(w_["requests"]):
                tensors = dict(eng.weights)
                tensors.update({k_: torch.from_numpy(v).to(dev) for k_, v
                                in eng._padded(req, w_["bucket"]).items()})
                _, rep = per.run(cm, tensors)
                reports.append(rep)
                check(per.planned_codes.keys() == w_["codes"].keys(),
                      "a wave planned other kernels than a request alone")
                for out, codes in per.planned_codes.items():
                    check(np.array_equal(w_["codes"][out][b_], codes)
                          and int(w_["formats"][out][b_])
                          == per.planned_formats[out],
                          f"request {req.request_id}: slot {b_} of its "
                          f"wave planned {out} otherwise than the request "
                          "alone")
        return reports

    runs = [(m_, "dynamic", None, STREAM_SLOTS) for m_ in
            ("gcn", "sage", "gin", "sgc", "gat")]
    runs += [("sage", s_, None, STREAM_SLOTS) for s_ in ("s1", "s2", "gemm")]
    runs += [("gcn", "dynamic", cheap, STREAM_SLOTS), ("sage", "dynamic",
                                                      None, 3)]
    stream = []
    for model, strategy, cost, slots in runs:
        eng = GraphServeEngine(model, f_in=STREAM_F_IN, hidden=16,
                               n_classes=7, slots=slots, weight_seed=0,
                               strategy=strategy, cost_model=cost,
                               keep_codes=True, device=dev)
        waves = []
        watch(eng, waves)
        K.reset_launch_counts()
        served = eng.serve(reqs)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        naive = eng.run_naive(reqs)
        label = (f"{model} {strategy}" + (" CSR" if cost else "")
                 + f" slots={slots}")
        bitwise = all(np.array_equal(a_.logits, b_.logits)
                      for a_, b_ in zip(served, naive))
        check(bitwise, f"serve != run_naive ({label})")
        check(eng.executor.trace_count == len(eng.buckets),
              f"{label}: {eng.executor.trace_count} walk plans for "
              f"{len(eng.buckets)} buckets")
        own = len(own_plans(eng, waves))
        check(own == STREAM_REQUESTS, f"{label}: {own} slots held to a "
              "per-request plan")
        for w_ in waves:
            check(w_["batched_launches"] == w_["request_inputs"],
                  f"{label}: {w_['batched_launches']} batched tile_nnz "
                  f"launches in a wave of {w_['request_inputs']} request "
                  "inputs")
            check(not w_["host_syncs"], f"{label}: launch_batch "
                  f"synchronized with the host: {w_['host_syncs']}")
            # a static strategy fixes its primitives whatever the data;
            # under dynamic an all-zero dummy slot plans nothing
            check(strategy != "dynamic" or w_["dummy_all_skip"],
                  f"{label}: a dummy slot planned work")
        check(counts["tile_nnz_batched"] == sum(
            w_["request_inputs"] for w_ in waves),
            f"{label}: batched launches {counts['tile_nnz_batched']}")
        if cost is not None:
            check(counts["csr_spmm"] > 0, f"{label}: csr_spmm never ran")
            check(any((f_ == Format.CSR).any() for f_ in
                      eng.executor.planned_formats.values()),
                  f"{label}: no kernel ran row-CSR")
        stream.append({"run": label, "buckets": eng.buckets,
                       "dummy_all_skip": all(w_["dummy_all_skip"]
                                             for w_ in waves),
                       "waves": len(waves), "traces": eng.executor.trace_count,
                       "launches": counts, "bitwise_naive": bitwise,
                       "codes_equal_per_request": own,
                       "wave_loads": [[w_["real"], w_["slots"]]
                                      for w_ in waves]})
        del eng, served, naive
    record("serving_stream", requests=STREAM_REQUESTS, f_in=STREAM_F_IN,
           sizes=list(STREAM_SIZES), seed=STREAM_SEED, runs=stream,
           host_syncs_in_launch_batch=0,
           sync_detection="torch.cuda.set_sync_debug_mode('warn')")

    # ---- (b) full width: SAGE at CiteSeer's widths ----------------------
    t0 = time.perf_counter()
    reqs = random_requests(CI_REQUESTS, f_in=CI_F_IN, sizes=CI_SIZES, seed=0,
                           avg_degree=CI_DEGREE, feat_density=CI_FEAT)
    make_s = time.perf_counter() - t0
    eng = GraphServeEngine("sage", f_in=CI_F_IN, hidden=16,
                           n_classes=CI_CLASSES,
                           slots=4, min_bucket=64, device=dev)
    buckets = sorted({eng.bucket_for(r_.n_vertices) for r_ in reqs})
    check(buckets == CI_BUCKETS, f"full-width buckets {buckets}")
    top = buckets[-1]
    waves = []
    unwatch = watch(eng, waves)
    served = eng.serve(reqs)                          # warm
    torch.cuda.synchronize()
    K.reset_launch_counts()
    waves.clear()
    served = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    waves_window = list(waves)
    record("serving_full_width_launches", counts=counts,
           waves=len(waves), per_wave=[
               {k_: w_[k_] for k_ in ("bucket", "real", "slots",
                                      "batched_launches")}
               for w_ in waves])
    for name in ("tile_nnz_batched", "tile_nnz", "dispatch"):
        check(counts[name] > 0, f"full-width serving never launched {name}")
    check(all(not w_["host_syncs"] and w_["batched_launches"]
              == w_["request_inputs"] for w_ in waves),
          "full-width serving: a wave synchronized or miscounted")
    naive = eng.run_naive(reqs)
    check(all(np.array_equal(a_.logits, b_.logits)
              for a_, b_ in zip(served, naive)),
          "full-width serve != run_naive")
    errs = []
    w64 = {k_: v.double() for k_, v in eng.weights.items()}
    for req, res in zip(reqs, served):
        pad = {k_: torch.from_numpy(v).to(dev).double()
               for k_, v in eng._padded(req, res.bucket).items()}
        a_, h0 = pad["A_mean"], pad["H0"]
        h = torch.relu(a_ @ (h0 @ w64["Wneigh1"]) + h0 @ w64["Wself1"])
        want = (a_ @ (h @ w64["Wneigh2"]) + h @ w64["Wself2"])
        want = want[: req.n_vertices]
        got = torch.from_numpy(res.logits).to(dev)
        check(bool(torch.isfinite(got).all()) and tuple(got.shape)
              == (req.n_vertices, CI_CLASSES), "full-width logits malformed")
        errs.append(float((got.double() - want).abs().max()))
        check(close(got, want, MODEL_TOL), f"full-width request "
              f"{req.request_id} vs float64 oracle: max|err|={errs[-1]}")
    del pad, a_, h0, h, want
    # each request plans from its own profile: every slot's codes and
    # formats, and its report rows' histogram, are those of the request
    # planned alone on the same padded tensors
    eng.executor.collect_report = eng.executor.keep_codes = True
    waves.clear()
    eng.serve(reqs)
    eng.executor.collect_report = eng.executor.keep_codes = False
    own = iter(own_plans(eng, waves))
    hists = []
    for w_ in waves:
        rep = w_["report"]
        for b_ in range(w_["slots"]):
            h_ = np.sum([r_.histogram for r_ in rep.kernels
                         if r_.name.endswith(f"[{b_}]")], axis=0)
            if b_ < w_["real"]:
                check(np.array_equal(h_, next(own).histogram),
                      f"full-width wave {w_['bucket']} slot {b_}: report "
                      "histogram differs from the request planned alone")
            hists.append({"bucket": w_["bucket"], "slot": b_,
                          "real": b_ < w_["real"], "histogram": h_.tolist()})
    real_h = [tuple(h_["histogram"]) for h_ in hists if h_["real"]]
    check(len(real_h) == CI_REQUESTS and len(set(real_h)) > 1,
          "full-width requests do not each plan their own histogram")
    check(all(h_["histogram"][1:] == [0, 0, 0] for h_ in hists
              if not h_["real"]), "a full-width dummy slot planned work")
    record("serving_histograms", requests=hists,
           distinct_real=len(set(real_h)), codes_equal_per_request=len(
               real_h))
    # timed serves (one warm above) through the engine's own entry points,
    # with the checks' wrappers taken off: walls from the host clock
    # around serve (the last wave ends in a synchronize) and the waves'
    # own launch-to-ready walls (engine.bucket_walls); the gather and
    # copy-enqueue times, taken in begin_wave before launch_batch, come
    # from the launch-count window above
    unwatch()
    eng.bucket_walls = {}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.serve(reqs)
        walls.append(time.perf_counter() - t0)
    eng.run_naive(reqs)
    naive_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_naive(reqs)
        naive_walls.append(time.perf_counter() - t0)
    timed = eng.bucket_walls
    by_bucket = {}
    for w_ in waves_window:
        by_bucket.setdefault(w_["bucket"], []).append(w_)
    waves_per_serve = len(waves_window)
    prof = profile_device(torch, lambda: eng.serve(reqs), n=2, top=12)
    busy = prof["device_busy_ms"]
    # the wave stack of the top bucket: pinned host -> device copy
    host = {k_: torch.zeros((4,) + eng._input_shape(k_, top),
                            pin_memory=True) for k_ in ("A_mean", "H0")}
    copy_ms = cuda_ms(torch, lambda: [v.to(dev, non_blocking=True)
                                      for v in host.values()])
    copy_bytes = sum(v.numel() * 4 for v in host.values())
    del host
    # where a top-bucket wave's gather goes: the pinned zero buffers, the
    # normalization of each request's adjacency, the slot fills
    t0 = time.perf_counter()
    host = {k_: torch.zeros((4,) + eng._input_shape(k_, top),
                            pin_memory=True) for k_ in ("A_mean", "H0")}
    zero_s = time.perf_counter() - t0
    norm_s, fill_s = [], []
    big_reqs = [r_ for r_ in reqs if eng.bucket_for(r_.n_vertices) == top][:4]
    for i, r_ in enumerate(big_reqs):
        t0 = time.perf_counter()
        graph_data.normalize_adjacency(r_.adjacency)
        norm_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng._fill_slot(r_, {k_: v[i].numpy() for k_, v in host.items()})
        fill_s.append(time.perf_counter() - t0)
    del host
    record("serving_gather_breakdown", card=card, bucket=top,
           requests=len(big_reqs), zero_pinned_wave_ms=zero_s * 1e3,
           normalize_ms=[t_ * 1e3 for t_ in norm_s],
           fill_slot_ms=[t_ * 1e3 for t_ in fill_s])
    record("serving_full_width", card=card, model="sage", f_in=CI_F_IN,
           hidden=16, classes=CI_CLASSES, requests=CI_REQUESTS,
           sizes=list(CI_SIZES), avg_degree=CI_DEGREE,
           feat_density=CI_FEAT, slots=4, buckets=buckets,
           make_requests_s=make_s, waves_per_serve=waves_per_serve,
           serve_wall_ms=[w * 1e3 for w in walls],
           serve_wall_p50_ms=statistics.median(walls) * 1e3,
           requests_per_s_served=CI_REQUESTS / statistics.median(walls),
           naive_wall_ms=[w * 1e3 for w in naive_walls],
           requests_per_s_naive=CI_REQUESTS / statistics.median(naive_walls),
           wave_wall_p50_ms={b_: statistics.median(ws) * 1e3
                             for b_, ws in timed.items()},
           wave_wall_p50_ms_all=statistics.median(
               [w_ for ws in timed.values() for w_ in ws]) * 1e3,
           gather_ms_p50={b_: statistics.median(
               [w_["gather_s"] for w_ in ws]) * 1e3
               for b_, ws in by_bucket.items()},
           copy_enqueue_ms_p50={b_: statistics.median(
               [w_["copy_s"] for w_ in ws]) * 1e3
               for b_, ws in by_bucket.items()},
           h2d_copy_top_wave_ms=copy_ms,
           h2d_copy_top_wave_bytes=copy_bytes,
           h2d_copy_gb_per_s=copy_bytes / copy_ms / 1e6,
           device_busy_ms_per_serve=busy,
           device_busy_ms_per_wave=(busy / waves_per_serve
                                    if prof["complete"] else busy),
           idle_share=prof["idle_share"],
           wall_ms_profiled=prof["wall_ms_profiled"],
           top_device_ops=prof["top_device_ops"],
           max_abs_err_vs_f64=errs, tol=MODEL_TOL,
           bitwise_naive=True, launches_per_serve=counts,
           launches_per_wave={k_: v / len(waves_window)
                              for k_, v in counts.items()})

    # ---- the batched route at the full-width wave's shape ---------------
    cm = eng._compile(top)
    blk = next(b_ for n_, b_ in runtime.FusedModelExecutor._needed_inputs(
        runtime.FusedModelExecutor._resolved_flows(cm)) if n_ == "A_mean")
    stack = torch.zeros((4, top, top), device=dev)
    for i, r_ in enumerate(big_reqs):
        stack[i] = torch.from_numpy(eng._padded(r_, top)["A_mean"]).to(dev)
    bm_, bn_ = blk
    kernel_entry(
        "tile_nnz_batched", "src/repro_torch/kernels/csrc/tile_nnz.cu",
        "src/repro/core/profiler.py:60 (jnp batched_block_counts; the "
        "Pallas tile_nnz is src/repro/kernels/profile.py:25)",
        lambda: P.tile_nnz_batched(stack, blk),
        lambda: P.tile_nnz_plain(stack, blk),
        lambda: torch.count_nonzero(stack.view(
            4, top // bm_, bm_, top // bn_, bn_), dim=(2, 4)),
        # one compare and one add per element; the stack read once, the
        # counts written once
        (2.0 * stack.numel(), 4.0 * stack.numel()
         + 4.0 * 4 * (top // bm_) * (top // bn_)),
        lambda g, w: True, units="simt",
        lib_call="torch.count_nonzero(x.view(B, Mb, bm, Nb, bn), "
                 "dim=(2, 4))",
        launches=counts["tile_nnz_batched"])
    record("tile_nnz_batched_vs_per_slot", card=card,
           shape=[4, top, top], block=list(blk),
           batched_ms=cuda_ms(torch, lambda: P.tile_nnz_batched(stack,
                                                                 blk)),
           per_slot_2d_ms=cuda_ms(torch, lambda: [P.tile_nnz(stack[i], blk)
                                                  for i in range(4)]),
           launches_per_wave=waves_window[0]["request_inputs"])
    del stack
    return counts


# benchmarks/bench_serving.py:337-359 (_continuous_parity): the reference's
# continuous parity stream, 6 requests of the first two stream sizes, seed
# 13, waves of 3, max_wait 0.01, deadlines 60 s after submit
PARITY_REQUESTS, PARITY_SEED, PARITY_SLOTS = 6, 13, 3
# benchmarks/bench_serving.py:722-803 (_bench_overload, run_overload), at
# SAGE with CiteSeer's widths: the reference's deep replay of 96 requests
# (24 waves' worth, so that at 10x the backlog takes ~24 wave walls to
# clear against a 6-wall budget), Poisson arrivals (seed 100) at 1x, 3x and
# 10x the capacity a sync serve of the same requests measures, deadlines 6
# wave walls after arrival, shedding armed at half that budget; every 4th
# request is the "gold" class (priority 1)
OVER_REQUESTS, OVER_LOADS, OVER_BUDGET, OVER_SEED = 96, (1, 3, 10), 6.0, 100
ADMITTED_FLOOR = 0.9  # the reference's admitted hit-rate gate at >= 3x
#                       (bench_serving.py run_overload's hit_floor)
FLIGHT_REQUESTS = 24  # the two-waves-in-flight passes: the first 24 (7 waves)


def scripted_policy_run(np, engine, reqs, n_lanes, policy):
    """Phase 5d (b): the CPU tests' scripted stream
    (``tests/torch_scripted_stream.py``) through one server on
    ``engine``, under a fake clock with scripted walls.  Returns (server,
    tickets, results)."""
    from repro_torch.serving.scheduler import ContinuousGraphServer
    from torch_scripted_stream import (SERVER_KW, script_walls, stream,
                                       stream_clock)
    clk = stream_clock()
    script_walls(engine, clk)
    srv = ContinuousGraphServer(engine, clock=clk, n_lanes=n_lanes,
                                **SERVER_KW, **policy)
    srv.warmup((20,))
    tickets, done = stream(srv, clk, reqs, np.random.default_rng(3))
    del engine.finish_wave
    return srv, tickets, done


def replay(torch, np, K, engine, reqs, arrivals, budget, *, shed,
           pressure_threshold, warm_reqs):
    """Phase 5d (c): one open-loop Poisson replay on the host clock, as
    ``bench_serving._replay_overload`` runs it, at one lane: the server is
    warmed with two deadline-less waves (``warm_reqs``; results dropped),
    then each request is submitted when the clock passes its arrival
    (deadline = arrival + budget), polling between arrivals, and the stream
    ends with a drain.  Every submit pays its own ``request_cost`` (the
    memo is cleared first, as for new requests).  Returns the server,
    tickets, results, timings and the replay window's launch counts."""
    from repro_torch.serving.scheduler import ContinuousGraphServer
    srv = ContinuousGraphServer(engine, shed=shed,
                                pressure_threshold=pressure_threshold)
    for r in warm_reqs:
        srv.submit(r, tenant="warmup")
    srv.drain()
    srv.peak_pressure = 0.0
    for r in reqs:
        r.__dict__.pop("_dynasparse_cost", None)
    w0 = len(srv.dispatch_log)
    # the EWMA estimate each cut used: estimates change only at harvest,
    # so they are read right after the cut
    est_at_cut = {}
    cut_ready = srv._cut_ready

    def watched_cut_ready(now, **kw):
        ready = cut_ready(now, **kw)
        for bucket, _, _, cut_at in ready:
            est_at_cut[(bucket, cut_at)] = srv.estimate(bucket)
        return ready

    srv._cut_ready = watched_cut_ready
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.monotonic()
    abs_arrival = t0 + np.asarray(arrivals)
    n, i, done, tickets, submit_s = len(reqs), 0, [], [], []
    while i < n:
        now = time.monotonic()
        while i < n and abs_arrival[i] <= now:
            gold = i % 4 == 0
            ts = time.perf_counter()
            tickets.append(srv.submit(
                reqs[i], deadline=float(abs_arrival[i]) + budget,
                priority=1 if gold else 0, tenant="gold" if gold else "std"))
            submit_s.append(time.perf_counter() - ts)
            i += 1
        got = srv.poll()
        done += got
        if not got and i < n:
            time.sleep(min(max(abs_arrival[i] - time.monotonic(), 0.0),
                           1e-3) if not srv.pending else 5e-4)
    done += srv.drain()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    waves = srv.dispatch_log[w0:]
    # each wave's results come in harvest order, as the log does, and
    # carry its delivery time.  At one lane a wave starts once its cut is
    # made and the wave before it is delivered, so its own wall is the
    # marginal one, delivery - max(cut, previous delivery), as the
    # server's admission floor (_wave_floor) takes it; delivery - cut is
    # its sojourn from the cut, which holds the walls of the waves cut in
    # the same tick ahead of it
    it = iter(done)
    per_wave, prev_done = [], t0
    for w_ in waves:
        res = [next(it) for _ in range(w_.n_real)]
        done_at = res[0].completed_at
        per_wave.append({"bucket": w_.bucket, "n_real": w_.n_real,
                         "reason": w_.reason,
                         "estimate_s": est_at_cut[(w_.bucket, w_.cut_at)],
                         "launch_to_ready_s": w_.wall,
                         "marginal_wall_s": done_at - max(w_.cut_at,
                                                          prev_done),
                         "sojourn_from_cut_s": done_at - w_.cut_at})
        prev_done = done_at
    return dict(srv=srv, tickets=tickets, done=done, t0=t0,
                abs_arrival=abs_arrival, submit_s=submit_s,
                counts=counts, waves=per_wave)


def host_memory(torch, trim: bool = False) -> dict:
    """The caching host allocator's pinned segments (bytes held, and the
    pinned allocations and frees it has made), its ``active_bytes``
    counter, and the process's resident memory (VmRSS); with ``trim``,
    after glibc's ``malloc_trim`` hands the heap's free pages back, so
    that what stays resident is memory still in use."""
    if trim:
        try:
            import ctypes
            ctypes.CDLL("libc.so.6").malloc_trim(0)
        except (OSError, AttributeError):
            pass
    stats = getattr(torch.cuda, "host_memory_stats", None)
    out = {}
    if stats is not None:
        torch.empty(1, pin_memory=True)   # the allocator frees on allocate
        s_ = stats()
        out = {k_: s_.get(k_) for k_ in (
            "allocated_bytes.current", "active_bytes.current",
            "num_host_alloc", "num_host_free")}
    try:
        with open("/proc/self/status") as f:
            rss = [ln for ln in f if ln.startswith("VmRSS:")]
        out["rss_bytes"] = int(rss[0].split()[1]) * 1024 if rss else None
    except OSError:
        out["rss_bytes"] = None
    return out


def continuous_phase(torch, np, K, dev, card) -> None:
    """Phase 5d: continuous serving (``ContinuousGraphServer``).

    (a) the reference's continuous parity stream through all five models
    and GCN's row-CSR route: each request delivered once, == run_naive
    bitwise, walk plans <= buckets, waves <= slots, one batched
    ``tile_nnz`` launch per request input per wave; (b) the policy under a
    fake clock with scripted walls, on the card and on the CPU with the
    same code: equal dispatch logs, tickets, class counters and shed logs,
    every cut reason and shed kind seen, conservation, == run_naive
    bitwise; (c) SAGE at CiteSeer's widths: two waves in flight against
    one (no host sync inside ``begin_wave`` while a wave is in flight, the
    pinned buffers released after ``finish_wave``), then one-lane Poisson
    replays of 96 requests at 1x, 3x and 10x the measured capacity under
    ``shed="never"`` and ``"predicted-miss"``: conservation, == run_naive
    bitwise, 3 ``tile_nnz_batched`` launches per wave, with hit-rates,
    goodput, sojourns, the EWMA estimate against each wave's marginal
    wall, ``request_cost`` per submit, the device's idle share and the
    host's pinned and resident memory."""
    import collections
    import gc
    import warnings
    from repro_torch.core import runtime
    from repro_torch.core.perf_model import TPUCostModel
    from repro_torch.serving.graph_engine import (GraphServeEngine,
                                                  random_requests)
    from repro_torch.serving.scheduler import ContinuousGraphServer

    def inputs_per_wave(eng, bucket):
        flows = runtime.FusedModelExecutor._resolved_flows(
            eng._compiled[bucket])
        return len([n_ for n_, _ in runtime.FusedModelExecutor
                    ._needed_inputs(flows) if n_ in eng._input_names[bucket]])

    def bitwise_naive(done, naive, label):
        ids = [r_.request_id for r_ in done]
        check(len(ids) == len(set(ids)), f"{label}: a request delivered twice")
        for r_ in done:
            check(np.array_equal(r_.logits, naive[r_.request_id].logits),
                  f"{label}: request {r_.request_id} != run_naive")

    # ---- (a) the reference's continuous parity stream --------------------
    t_part = time.perf_counter()
    cheap = dataclasses.replace(TPUCostModel(), eff_transform=1.0,
                                transform_overhead_s=0.0)
    reqs = random_requests(PARITY_REQUESTS, f_in=STREAM_F_IN,
                           sizes=STREAM_SIZES[:2], seed=PARITY_SEED)
    parity = []
    for model, cost in [(m_, None) for m_ in
                        ("gcn", "sage", "gin", "sgc", "gat")] + [("gcn",
                                                                  cheap)]:
        label = model + (" CSR" if cost else "")
        eng = GraphServeEngine(model, f_in=STREAM_F_IN, hidden=16,
                               n_classes=7, slots=PARITY_SLOTS,
                               weight_seed=0, cost_model=cost, device=dev)
        srv = ContinuousGraphServer(eng, max_wait=0.01)
        K.reset_launch_counts()
        done = []
        for r_ in reqs:
            srv.submit(r_, deadline=time.monotonic() + 60.0)
            done += srv.poll()
        while srv.pending:
            done += srv.drain()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check(sorted(r_.request_id for r_ in done)
              == sorted(r_.request_id for r_ in reqs),
              f"{label}: not every request delivered once")
        bitwise_naive(done, {r_.request_id: r_ for r_ in eng.run_naive(reqs)},
                      f"continuous {label}")
        check(eng.executor.trace_count <= len(eng.buckets),
              f"{label}: {eng.executor.trace_count} walk plans for "
              f"{len(eng.buckets)} buckets")
        check(all(w_.n_real <= PARITY_SLOTS for w_ in srv.dispatch_log),
              f"{label}: a wave over {PARITY_SLOTS} slots")
        check(counts["tile_nnz_batched"] == sum(
            inputs_per_wave(eng, w_.bucket) for w_ in srv.dispatch_log),
            f"{label}: {counts['tile_nnz_batched']} batched launches for "
            f"{len(srv.dispatch_log)} waves")
        if cost is not None:
            check(counts["csr_spmm"] > 0, f"{label}: csr_spmm never ran")
        parity.append({"run": label, "buckets": eng.buckets,
                       "traces": eng.executor.trace_count,
                       "waves": [[w_.bucket, w_.n_real, w_.reason]
                                 for w_ in srv.dispatch_log],
                       "launches": counts, "bitwise_naive": True})
        del eng, srv
    record("continuous_parity", requests=PARITY_REQUESTS, f_in=STREAM_F_IN,
           sizes=list(STREAM_SIZES[:2]), seed=PARITY_SEED,
           slots=PARITY_SLOTS, max_wait=0.01, runs=parity,
           seconds=time.perf_counter() - t_part)

    # ---- (b) the policy under a fake clock, scripted walls ---------------
    t_part = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_scripted_stream as scripted
    reqs = random_requests(scripted.N_STREAM, f_in=32,
                           sizes=scripted.STREAM_SIZES,
                           seed=scripted.STREAM_SEED)
    reasons, sheds, policy_runs, naive = collections.Counter(), 0, [], None
    for name, policy in scripted.POLICIES.items():
        for n_lanes in (1, 2):
            runs = []
            for where in (dev, "cpu"):
                eng = GraphServeEngine("gcn", f_in=32, hidden=8, n_classes=6,
                                       slots=3, min_bucket=32, device=where)
                runs.append((eng,) + scripted_policy_run(
                    np, eng, reqs, n_lanes, policy))
            (eng, srv, tickets, done), (_, c_srv, c_tickets, c_done) = runs
            label = f"scripted {name} n_lanes={n_lanes}"

            def log(s_):
                return [(w_.bucket, w_.n_real, w_.reason, w_.cut_at, w_.wall,
                         w_.lane, w_.classes) for w_ in s_.dispatch_log]

            check(log(srv) == log(c_srv), f"{label}: dispatch log differs "
                  "from the CPU's")
            check([(int(t_), t_.verdict, t_.predicted_miss, t_.bucket,
                    t_.predicted_wall) for t_ in tickets]
                  == [(int(t_), t_.verdict, t_.predicted_miss, t_.bucket,
                       t_.predicted_wall) for t_ in c_tickets],
                  f"{label}: tickets differ from the CPU's")
            check({k_: dataclasses.astuple(v) for k_, v in
                   srv.class_stats.items()} == {
                       k_: dataclasses.astuple(v)
                       for k_, v in c_srv.class_stats.items()}
                  and [int(t_) for t_ in srv.shed_log]
                  == [int(t_) for t_ in c_srv.shed_log],
                  f"{label}: class counters or shed log differ")
            check(len(done) + len(srv.shed_log) == srv.submitted == len(reqs),
                  f"{label}: {len(done)} delivered + {len(srv.shed_log)} "
                  f"shed != {srv.submitted} submitted")
            if naive is None:           # every run's engine: seed 0
                naive = {r_.request_id: r_ for r_ in eng.run_naive(reqs)}
            bitwise_naive(done, naive, label)
            for a_, b_ in zip(done, c_done):
                check(bool(np.allclose(a_.logits, b_.logits, atol=TOL,
                                       rtol=TOL)),
                      f"{label}: card logits vs CPU beyond {TOL}")
            reasons.update(w_.reason for w_ in srv.dispatch_log)
            sheds += len(srv.shed_log)
            policy_runs.append({
                "run": label, "waves": len(srv.dispatch_log),
                "reasons": dict(collections.Counter(
                    w_.reason for w_ in srv.dispatch_log)),
                "delivered": len(done), "shed_at_submit": srv.shed_at_submit,
                "shed_under_pressure": srv.shed_under_pressure,
                "equal_cpu_policy": True, "bitwise_naive": True})
    check(set(reasons) == {"full", "deadline", "age", "drain"} and sheds > 0,
          f"scripted streams cut {dict(reasons)} and shed {sheds}")
    record("continuous_policy", requests=len(reqs), runs=policy_runs,
           reasons=dict(reasons), seconds=time.perf_counter() - t_part)

    # ---- (c) full width: SAGE at CiteSeer's widths -----------------------
    t_part = t0 = time.perf_counter()
    gc.collect()
    mem_start = host_memory(torch, trim=True)
    reqs = random_requests(OVER_REQUESTS, f_in=CI_F_IN, sizes=CI_SIZES,
                           seed=0, avg_degree=CI_DEGREE,
                           feat_density=CI_FEAT)
    make_s = time.perf_counter() - t0
    eng = GraphServeEngine("sage", f_in=CI_F_IN, hidden=16,
                           n_classes=CI_CLASSES, slots=4, min_bucket=64,
                           device=dev)
    # the servers' warm-up waves: two waves' worth of the stream's own
    # requests (the reference draws others from the same sizes)
    warm_reqs = reqs[: 2 * eng.slots]
    check(sorted({eng.bucket_for(r_.n_vertices) for r_ in reqs})
          == CI_BUCKETS, "full-width continuous buckets")
    # request_cost on the host, memo cold, per request
    cost_s = []
    for r_ in reqs:
        t0 = time.perf_counter()
        eng.request_cost(r_)
        cost_s.append(time.perf_counter() - t0)
    # capacity as the reference measures it: one warm serve, one timed
    eng.serve(reqs)
    t0 = time.perf_counter()
    eng.serve(reqs)
    serve_wall = time.perf_counter() - t0
    capacity = OVER_REQUESTS / serve_wall
    wave_wall = serve_wall * eng.slots / OVER_REQUESTS
    budget = OVER_BUDGET * wave_wall
    naive = {r_.request_id: r_ for r_ in eng.run_naive(reqs)}

    # two waves in flight against one, over the sync serve's waves of the
    # first FLIGHT_REQUESTS requests: host clock, serial / pipelined /
    # pipelined / serial; the first pipelined pass checks for host syncs
    # in each begin_wave made while a wave is in flight, and the pinned
    # buffers before and after
    waves = [(b_, [q for _, q in w_]) for b_, ws in
             eng._admit(reqs[:FLIGHT_REQUESTS]).items() for w_ in ws]
    host_stats = getattr(torch.cuda, "host_memory_stats", None)

    def serial():
        out = []
        for b_, w_ in waves:
            out += eng.finish_wave(eng.begin_wave(b_, w_))
        return out

    def pipelined(watch=None):
        out, prev = [], None
        for b_, w_ in waves:
            if prev is None or watch is None:
                h_ = eng.begin_wave(b_, w_)
            else:
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        h_ = eng.begin_wave(b_, w_)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                watch["syncs"] += [str(w.message)[:120] for w in caught
                                   if "ynchroniz" in str(w.message)]
                watch["in_flight"].append(host_memory(torch))
            if prev is not None:
                out += eng.finish_wave(prev)
            prev = h_
        return out + eng.finish_wave(prev)

    torch.cuda.synchronize()
    watch = {"syncs": [], "in_flight": [], "before": host_memory(torch)}
    got = pipelined(watch)
    torch.cuda.synchronize()
    watch["after"] = host_memory(torch)
    check(not watch["syncs"], "begin_wave synchronized with the host while a "
          f"wave was in flight: {watch['syncs']}")
    if host_stats is not None:
        # the pinned segments the caching host allocator holds: each wave's
        # buffers go back to it once their copy is done, so a pass with two
        # waves in flight holds no more than it held before, and has made
        # no more cudaHostAlloc calls than cudaFreeHost calls
        seg = "allocated_bytes.current"
        check(max(x_[seg] for x_ in watch["in_flight"] + [watch["after"]])
              <= watch["before"][seg],
              f"pinned host memory grew over two waves in flight: {watch}")

        def live(x_):
            if x_["num_host_alloc"] is None or x_["num_host_free"] is None:
                return None
            return x_["num_host_alloc"] - x_["num_host_free"]

        check(live(watch["before"]) is None
              or live(watch["after"]) <= live(watch["before"]),
              f"pinned host segments left over two waves in flight: {watch}")
    flight, outs = {"serial_s": [], "pipelined_s": []}, {}
    for key, fn in (("serial_s", serial), ("pipelined_s", pipelined),
                    ("pipelined_s", pipelined), ("serial_s", serial)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[key] = fn()
        flight[key].append(time.perf_counter() - t0)
    check(all(np.array_equal(a_.logits, b_.logits) for a_, b_ in
              zip(got + outs["pipelined_s"], 2 * outs["serial_s"])),
          "two waves in flight != one at a time")
    top = CI_BUCKETS[-1]
    wave_bytes = sum(4 * eng.slots * int(np.prod(eng._input_shape(n_, top)))
                     for n_ in eng._input_names[top])
    record("continuous_two_waves_in_flight", card=card,
           requests=FLIGHT_REQUESTS, waves=len(waves),
           host_syncs_in_begin_wave=0, bitwise_one_at_a_time=True,
           host_memory=watch if host_stats else "not measured",
           pinned_bytes_per_top_wave=wave_bytes,
           serial_wall_s=flight["serial_s"],
           pipelined_wall_s=flight["pipelined_s"],
           pipelined_over_serial=(statistics.median(flight["pipelined_s"])
                                  / statistics.median(flight["serial_s"])))

    def evaluate(rep, label):
        """Conservation, == run_naive bitwise and 3 batched launches per
        wave for one replay; returns its record fields."""
        srv, done = rep["srv"], rep["done"]
        req_of = {int(t_): r_ for t_, r_ in zip(rep["tickets"], reqs)}
        shed_ids = sorted(req_of[int(t_)].request_id for t_ in srv.shed_log)
        ids = sorted(r_.request_id for r_ in done)
        check(sorted(ids + shed_ids) == sorted(r_.request_id for r_ in reqs),
              f"{label}: {len(ids)} delivered + {len(shed_ids)} shed != "
              f"{OVER_REQUESTS} submitted")
        bitwise_naive(done, naive, label)
        counts, w_ = rep["counts"], rep["waves"]
        check(counts["tile_nnz_batched"] == 3 * len(w_)
              and counts["dispatch"] > 0 and counts["tile_nnz"] > 0,
              f"{label}: {counts} for {len(w_)} waves")
        by_arrival = {r_.request_id: a_ for r_, a_ in
                      zip(reqs, rep["abs_arrival"])}
        lat = [r_.completed_at - by_arrival[r_.request_id] for r_ in done]
        met = sum(bool(r_.deadline_met) for r_ in done)
        span = (max(r_.completed_at for r_ in done) - rep["t0"]
                if done else 0.0)

        def mean_ms(key):
            return float(np.mean([x_[key] for x_ in w_]) * 1e3)

        return dict(
            submitted=OVER_REQUESTS, delivered=len(done),
            shed_count=len(shed_ids), shed_at_submit=srv.shed_at_submit,
            shed_under_pressure=srv.shed_under_pressure,
            met=met, missed=len(done) - met,
            overall_hit_rate=met / OVER_REQUESTS,
            admitted_hit_rate=met / len(done) if done else 1.0,
            reference_admitted_floor=ADMITTED_FLOOR,
            goodput_rps=met / span if span else 0.0, span_s=span,
            p50_sojourn_ms=float(np.percentile(lat, 50) * 1e3),
            p99_sojourn_ms=float(np.percentile(lat, 99) * 1e3),
            waves=len(w_), wave_loads=[x_["n_real"] for x_ in w_],
            cut_reasons=dict(collections.Counter(x_["reason"] for x_ in w_)),
            mean_estimate_ms=mean_ms("estimate_s"),
            mean_launch_to_ready_ms=mean_ms("launch_to_ready_s"),
            mean_marginal_wall_ms=mean_ms("marginal_wall_s"),
            mean_sojourn_from_cut_ms=mean_ms("sojourn_from_cut_s"),
            median_marginal_over_estimate=float(np.median(
                [x_["marginal_wall_s"] / x_["estimate_s"] for x_ in w_])),
            per_wave=w_,
            submit_ms_mean=float(np.mean(rep["submit_s"]) * 1e3),
            peak_pressure_s=srv.peak_pressure,
            class_stats={f"{t_}/p{p_}": dataclasses.astuple(s_)
                         for (t_, p_), s_ in sorted(srv.class_stats.items())},
            launches=counts, bitwise_naive=True)

    prof = None
    for load in OVER_LOADS:
        rate = load * capacity
        arrivals = np.cumsum(np.random.default_rng(OVER_SEED).exponential(
            1.0 / rate, OVER_REQUESTS))
        for shed in ("never", "predicted-miss"):
            label = f"x{load} {shed}"
            runs = []

            def run():
                runs.append(replay(
                    torch, np, K, eng, reqs, arrivals, budget, shed=shed,
                    warm_reqs=warm_reqs,
                    pressure_threshold=(budget / 2 if shed == "predicted-miss"
                                        else float("inf"))))

            if prof is None:
                # the first replay is also the profiler's warm-up call;
                # the device busy and idle share are those of a second
                # replay of the same stream
                prof = profile_device(torch, run, n=1, top=8)
                prof_fields = evaluate(runs[-1], label + " profiled")
                prof.update(label=label, **{k_: prof_fields[k_] for k_ in (
                    "delivered", "shed_count", "met", "span_s", "waves")})
            else:
                run()
            record("continuous_replay", card=card, load=load, shed=shed,
                   n_lanes=1, arrival_rate_rps=rate,
                   **evaluate(runs[0], label))
    del eng, reqs, warm_reqs, naive, waves, got, outs, runs
    gc.collect()
    torch.cuda.empty_cache()
    record("continuous_full_width", card=card, model="sage", f_in=CI_F_IN,
           hidden=16, classes=CI_CLASSES, requests=OVER_REQUESTS,
           sizes=list(CI_SIZES), avg_degree=CI_DEGREE, feat_density=CI_FEAT,
           slots=4, buckets=CI_BUCKETS, make_requests_s=make_s,
           sync_serve_wall_s=serve_wall, capacity_rps=capacity,
           wave_wall_ms=wave_wall * 1e3, budget_ms=budget * 1e3,
           request_cost_ms=[t_ * 1e3 for t_ in cost_s],
           request_cost_ms_mean=float(np.mean(cost_s) * 1e3),
           replay_profiled=prof,
           host_memory={"start": mem_start, "end": host_memory(torch),
                        "end_trimmed": host_memory(torch, trim=True)},
           seconds=time.perf_counter() - t_part)


# bench_serving.py:844-943 (_bench_minibatch), at Reddit's widths
# (TABLE_VI["RE"], src/repro/data/graphs.py:54: 232,965 vertices, 602
# features, hidden 128, 41 classes): one power-law host graph at the
# ladder's degree recipe (avg_degree 8, seed 0), its features drawn from
# default_rng(3), 200 queries of 1-4 seeds under powerlaw_marginal weights
# at alpha 1.6 from the same generator, fanouts (8, 4), cache 4096,
# arrival chunks of 8, waves of 8, FPGA model, dynamic.  The reference's
# floors (hit-rate 0.5, 2.0x naive seeds/s) are printed, not gated.
MB_VERTICES, MB_DEGREE, MB_F_IN, MB_HIDDEN, MB_CLASSES = (232_965, 8, 602,
                                                          128, 41)
MB_QUERIES, MB_ALPHA, MB_FANOUTS, MB_CACHE, MB_CHUNK = (200, 1.6, (8, 4),
                                                        4096, 8)
MB_SLOTS, MB_BUCKET = 8, 64         # 1 + 8 + 32 = 41 vertices at most
# busy and idle are profiled over the first 3 chunks of a cold pass: on
# an H100 machine the profiler's own processing of a whole pass's events
# took 31-37 s a model
MB_PROFILED = 24
MB_HIT_FLOOR, MB_SPEEDUP_FLOOR = 0.5, 2.0
# (b): an edge delta of 8 inserts and 8 deletes every 25 queries, drawn
# from default_rng(5); the 16 most-queried vertices' rows updated once,
# at query 100
MB_DELTA_EVERY, MB_DELTA_EDGES, MB_UPDATE_AT, MB_HOT = 25, 8, 100, 16


def minibatch_phase(torch, np, K, dev, card) -> None:
    """Phase 5e: mini-batch serving over one giant graph.

    (a) the reference's mini-batch ladder at Reddit's widths, GCN and
    SAGE: the naive per-seed loop (sample, then ``run_naive``) is the
    oracle, and every row ``MiniBatchServeEngine.serve_queries`` gives must
    equal its seed's naive row bitwise; the cache counters must conserve
    and every wave must launch what one ``run_batch`` wave of the same
    model and bucket launches.  Seeds/s both ways, hit-rate, waves and
    padding, sample, cache, gather and launch-to-ready seconds, and the
    device's busy and idle share over the first chunks of a cold pass.  (b) GAT through
    ``ContinuousGraphServer.submit_query`` with a real clock, an edge
    delta every 25 queries and one store update: every query completes,
    each delivered request is ``sample_subgraph`` on its graph version and
    ``run_naive`` of itself bitwise, every query's rows and every final
    cache entry are bitwise the oracle at the graph and store versions of
    its submission (the final ones for the cache), and each delta's
    patched profile and replan count equal a profile from scratch and two
    full ``plan_codes`` replans on the card."""
    import collections
    from repro_torch.core import analyzer
    from repro_torch.data.graphs import powerlaw_marginal
    from repro_torch.data.sampling import (AdjacencyBlockProfile,
                                           powerlaw_host_graph,
                                           sample_subgraph, vertex_seed)
    from repro_torch.serving.graph_engine import (GraphRequest,
                                                  GraphServeEngine)
    from repro_torch.serving.minibatch import (FeatureStore,
                                               MiniBatchPlanner,
                                               MiniBatchServeEngine,
                                               SeedRequest, VertexCache)
    from repro_torch.serving.scheduler import ContinuousGraphServer
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    graph = powerlaw_host_graph(MB_VERTICES, avg_degree=MB_DEGREE, seed=0)
    graph_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    features = rng.standard_normal((MB_VERTICES, MB_F_IN), dtype=np.float32)
    store_s = time.perf_counter() - t0
    w = powerlaw_marginal(MB_VERTICES, rng, alpha=MB_ALPHA)
    queries = [rng.choice(MB_VERTICES, size=int(rng.integers(1, 5)),
                          p=w).tolist() for _ in range(MB_QUERIES)]
    n_seed_runs = sum(len(dict.fromkeys(q)) for q in queries)
    distinct = len({v for q in queries for v in q})
    record("minibatch_graph", card=card, vertices=graph.n_vertices,
           edges=graph.n_edges, mean_degree=graph.n_edges / graph.n_vertices,
           max_degree=int(graph.degrees.max()), graph_s=graph_s,
           store_mb=features.nbytes / 2**20, store_s=store_s,
           queries=MB_QUERIES, seed_runs=n_seed_runs,
           distinct_seeds=distinct, numpy=np.__version__)

    def timed(fn, acc):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc.append(time.perf_counter() - t)
        return wrapper

    # ---- (a) the mini-batch ladder, GCN and SAGE --------------------------
    for model in ("gcn", "sage"):
        t_model = time.perf_counter()
        store = FeatureStore(features)
        eng = GraphServeEngine(model, f_in=MB_F_IN, hidden=MB_HIDDEN,
                               n_classes=MB_CLASSES, slots=MB_SLOTS,
                               weight_seed=0, device=dev)
        # parity first, on a throwaway front end (its own cold cache), which
        # also builds the bucket's walk plan and warms the naive engine
        warm = MiniBatchServeEngine(eng, graph, store, fanouts=MB_FANOUTS,
                                    cache_capacity=MB_CACHE)
        for t_, want in zip(warm.serve_queries(queries[:4]),
                            warm.oracle_queries(queries[:4])):
            check(np.array_equal(t_.result(), want),
                  f"minibatch {model}: query {t_.query_id} != its oracle")
        # one run_batch wave of this model and bucket: the launches every
        # mini-batch wave must make
        one = warm.planner.request_for(queries[0][0])
        check(eng.bucket_for(one.n_vertices) == MB_BUCKET,
              f"minibatch {model}: a subgraph left bucket {MB_BUCKET}")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        eng.dispatch_wave(MB_BUCKET, [one])
        torch.cuda.synchronize()
        wave_counts = K.launch_counts()
        # the naive loop, and the oracle: per query, per unique seed,
        # sample then one run_naive
        naive_rows = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in queries:
            for v in dict.fromkeys(q):
                req = SeedRequest(warm.planner.sample(v), store,
                                  request_id=-1)
                row = eng.run_naive([req])[0].logits[0]
                if v in naive_rows:
                    check(np.array_equal(naive_rows[v], row),
                          f"minibatch {model}: naive rows of {v} differ")
                naive_rows[v] = row
        t_naive = time.perf_counter() - t0
        # the mini-batch pass, cold cache, in arrival chunks
        mb = MiniBatchServeEngine(eng, graph, store, fanouts=MB_FANOUTS,
                                  cache_capacity=MB_CACHE)
        planner = mb.planner
        sample_s, lookup_s, complete_s, waves = [], [], [], []
        planner.sample = timed(planner.sample, sample_s)
        planner.lookup = timed(planner.lookup, lookup_s)
        planner.complete = timed(planner.complete, complete_s)
        dispatch = eng.dispatch_wave

        def dispatch_wave(bucket, wave):
            before = K.launch_counts()
            res = dispatch(bucket, wave)
            rep = eng.last_wave_report
            after = K.launch_counts()
            waves.append({"bucket": bucket, "real": len(wave),
                          "gather_s": rep.gather_seconds,
                          "copy_s": rep.copy_seconds,
                          "launch_to_ready_s": rep.fused_wall_seconds,
                          "launches": {k_: after[k_] - before[k_]
                                       for k_ in after}})
            return res

        eng.dispatch_wave = dispatch_wave
        w0 = eng.waves
        tickets = []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(0, MB_QUERIES, MB_CHUNK):
            tickets += mb.serve_queries(queries[i:i + MB_CHUNK])
        torch.cuda.synchronize()
        t_mb = time.perf_counter() - t0
        counts = K.launch_counts()
        del eng.dispatch_wave
        for name in ("tile_nnz_batched", "tile_nnz", "dispatch"):
            check(counts[name] > 0, f"minibatch {model} never launched "
                                    f"{name}")
        check(len(waves) == eng.waves - w0 and waves,
              f"minibatch {model}: waves went around dispatch_wave")
        for t_ in tickets:
            check(t_.done, f"minibatch {model}: query {t_.query_id} open")
            got = t_.result()
            check(got.shape == (len(t_.seeds), MB_CLASSES)
                  and bool(np.isfinite(got).all()),
                  f"minibatch {model}: query {t_.query_id} malformed")
            for row, v in zip(got, t_.seeds):
                check(np.array_equal(row, naive_rows[v]),
                      f"minibatch {model}: seed {v} of query "
                      f"{t_.query_id} != its naive run_naive row")
        s = mb.cache.stats
        check(s.hits + s.misses == s.lookups and s.insertions
              == s.evictions + s.invalidations + len(mb.cache),
              f"minibatch {model}: cache counters do not conserve "
              f"{s.as_dict()} with {len(mb.cache)} resident")
        for w_ in waves:
            check(w_["bucket"] == MB_BUCKET and w_["launches"]
                  == wave_counts, f"minibatch {model}: a wave of bucket "
                  f"{w_['bucket']} launched {w_['launches']}, one "
                  f"run_batch wave {wave_counts}")
        del planner.sample, planner.lookup, planner.complete

        def cold_pass():
            fresh = MiniBatchServeEngine(eng, graph, store,
                                         fanouts=MB_FANOUTS,
                                         cache_capacity=MB_CACHE)
            for i in range(0, MB_PROFILED, MB_CHUNK):
                fresh.serve_queries(queries[i:i + MB_CHUNK])

        t0 = time.perf_counter()
        prof = profile_device(torch, cold_pass, n=1, top=8)
        profile_s = time.perf_counter() - t0
        n_waves = len(waves)
        gather = [w_["gather_s"] for w_ in waves]
        walk = [w_["launch_to_ready_s"] for w_ in waves]
        loads = sum(w_["real"] for w_ in waves)
        naive_sps, mb_sps = n_seed_runs / t_naive, n_seed_runs / t_mb
        record("minibatch_ladder", card=card, model=model,
               vertices=graph.n_vertices, edges=graph.n_edges,
               f_in=MB_F_IN, hidden=MB_HIDDEN, classes=MB_CLASSES,
               slots=MB_SLOTS, fanouts=list(MB_FANOUTS),
               cache_capacity=MB_CACHE, chunk=MB_CHUNK,
               traffic_alpha=MB_ALPHA, queries=MB_QUERIES,
               seed_runs=n_seed_runs, naive_s=t_naive, minibatch_s=t_mb,
               naive_seeds_per_s=naive_sps,
               minibatch_seeds_per_s=mb_sps, speedup=mb_sps / naive_sps,
               speedup_floor_reference=MB_SPEEDUP_FLOOR,
               hit_rate=s.hit_rate, hit_floor_reference=MB_HIT_FLOOR,
               cache=s.as_dict(), resident=len(mb.cache), waves=n_waves,
               buckets=sorted({w_["bucket"] for w_ in waves}),
               padding_efficiency=loads / (n_waves * MB_SLOTS),
               samples=len(sample_s),
               sample_ms_per_seed=float(np.mean(sample_s)) * 1e3,
               sample_s=float(np.sum(sample_s)),
               cache_s=float(np.sum(lookup_s) + np.sum(complete_s)),
               cache_us_per_lookup=float(np.mean(lookup_s)) * 1e6,
               gather_ms_per_wave=float(np.mean(gather)) * 1e3,
               gather_ms_p50=statistics.median(gather) * 1e3,
               gather_s=float(np.sum(gather)),
               copy_enqueue_ms_per_wave=float(np.mean(
                   [w_["copy_s"] for w_ in waves])) * 1e3,
               launch_to_ready_ms_per_wave=float(np.mean(walk)) * 1e3,
               launch_to_ready_ms_p50=statistics.median(walk) * 1e3,
               launch_to_ready_s=float(np.sum(walk)),
               launches_per_wave=wave_counts, launches_pass=counts,
               profiled_queries=MB_PROFILED,
               device_busy_ms_cold_prefix=prof["device_busy_ms"],
               idle_share_cold_prefix=prof["idle_share"],
               wall_ms_profiled=prof["wall_ms_profiled"],
               top_device_ops=prof["top_device_ops"],
               bitwise_naive=True, profile_s=profile_s,
               seconds=time.perf_counter() - t_model)
        del eng, warm, mb, naive_rows, tickets

    # ---- (b) the mutating graph, continuously, on GAT ---------------------
    t_b = time.perf_counter()
    store = FeatureStore(features)
    gat = GraphServeEngine("gat", f_in=MB_F_IN, hidden=MB_HIDDEN,
                           n_classes=MB_CLASSES, slots=MB_SLOTS,
                           weight_seed=0, device=dev)
    planner = MiniBatchPlanner(graph, store, fanouts=MB_FANOUTS,
                               cache=VertexCache(MB_CACHE), model_key="gat")
    srv = ContinuousGraphServer(gat, minibatch=planner, shed="never")
    srv.warmup((MB_BUCKET,))
    delivered = []
    complete = planner.complete

    def watched_complete(result):
        req = planner._inflight[result.request_id]
        v, row = complete(result)
        delivered.append((req, row))
        return v, row

    planner.complete = watched_complete
    rng5 = np.random.default_rng(5)
    hot = np.asarray([v for v, _ in collections.Counter(
        v for q in queries for v in q).most_common(MB_HOT)], np.int64)
    hot_before = store.gather(hot).copy()
    graphs = {0: graph}
    deltas, versions, submit_at, qts = [], [], [], []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for i, q in enumerate(queries):
        if i and i % MB_DELTA_EVERY == 0:
            g = planner.graph
            ins = []
            while len(ins) < MB_DELTA_EDGES:
                u, v = (int(x) for x in rng5.integers(0, MB_VERTICES, 2))
                if u != v and not np.isin(v, g.neighbors(u)):
                    ins.append((u, v))
            dels = []
            while len(dels) < MB_DELTA_EDGES:
                u = int(rng5.integers(0, MB_VERTICES))
                nb = g.neighbors(u)
                if nb.size:
                    dels.append((u, int(nb[rng5.integers(0, nb.size)])))
            before, inflight = planner.profile, planner.inflight
            td = time.perf_counter()
            rep = srv.apply_delta(ins, dels)
            deltas.append({"report": rep, "before": before,
                           "after": planner.profile, "inflight": inflight,
                           "apply_s": time.perf_counter() - td})
            graphs[planner.graph_version] = planner.graph
        if i == MB_UPDATE_AT:
            store.update(hot, rng5.standard_normal(
                (MB_HOT, MB_F_IN), dtype=np.float32))
        versions.append((planner.graph_version, store.version))
        submit_at.append(time.monotonic())
        qts.append(srv.submit_query(q))
        srv.poll()
    for _ in range(50):
        if all(qt.done for qt in qts):
            break
        srv.drain()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    counts = K.launch_counts()
    del planner.complete
    check(all(qt.done for qt in qts), "minibatch stream: a query never "
          "completed")
    for name in ("tile_nnz_batched", "tile_nnz", "dispatch", "edge_softmax"):
        check(counts[name] > 0, f"minibatch stream never launched {name}")
    check(any(d_["inflight"] for d_ in deltas),
          "minibatch stream: no delta landed with requests in flight")

    def features_at(vertices, sv):
        rows = store.gather(vertices)
        if sv == 0:                      # before the store update
            pos = {int(v): i for i, v in enumerate(hot)}
            for j, v in enumerate(vertices):
                if int(v) in pos:
                    rows[j] = hot_before[pos[int(v)]]
        return rows

    def same_subgraph(a, b):
        return (np.array_equal(a.vertices, b.vertices)
                and np.array_equal(a.adjacency, b.adjacency)
                and len(a.hops) == len(b.hops)
                and all(np.array_equal(x, y) for x, y in zip(a.hops, b.hops)))

    oracle = {}
    t0 = time.perf_counter()
    for req, row in delivered:
        v, gv, sv = req.vertex, req.graph_version, req.store_version
        want = sample_subgraph(graphs[gv], [v], MB_FANOUTS,
                               seed=vertex_seed(0, v))
        check(same_subgraph(req.subgraph, want),
              f"minibatch stream: request {req.request_id} (vertex {v}) is "
              f"not sample_subgraph on graph version {gv}")
        naive = gat.run_naive([req])[0].logits[0]
        check(np.array_equal(row, naive), f"minibatch stream: request "
              f"{req.request_id} != run_naive of itself")
        oracle[(v, gv, sv)] = naive

    def oracle_row(v, gv, sv):
        key = (v, gv, sv)
        if key not in oracle:
            sub = sample_subgraph(graphs[gv], [v], MB_FANOUTS,
                                  seed=vertex_seed(0, v))
            oracle[key] = gat.run_naive([GraphRequest(
                sub.adjacency, features_at(sub.vertices, sv),
                request_id=-1)])[0].logits[0]
        return oracle[key]

    n_rows = 0
    for qt, (gv, sv) in zip(qts, versions):
        got = qt.result()
        for row, v in zip(got, qt.seeds):
            check(np.array_equal(row, oracle_row(v, gv, sv)),
                  f"minibatch stream: seed {v} of query {qt.query_id} is "
                  f"not the oracle at graph v{gv}, store v{sv}")
            n_rows += 1
    final = (planner.graph_version, store.version)
    for key, (value, _) in planner.cache._entries.items():
        check(np.array_equal(value, oracle_row(key[0], *final)),
              f"minibatch stream: cache entry {key} is stale")
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ones = np.ones((planner.profile.counts.shape[1], 1), np.float32)
    per_delta = []
    for d_ in deltas:
        rep, before, after = d_["report"], d_["before"], d_["after"]
        scratch = AdjacencyBlockProfile.from_graph(graphs[rep.graph_version],
                                                   planner.profile_block)
        check(np.array_equal(after.counts, scratch.counts),
              f"minibatch stream: delta to v{rep.graph_version}: patched "
              "profile != a profile from scratch")

        def full_codes(prof):
            dens = torch.from_numpy(prof.densities().astype(
                np.float32)).to(dev)
            return analyzer.plan_codes(gat.strategy, dens, torch.from_numpy(
                ones).to(dev), gat.executor.model)

        full = (full_codes(before) != full_codes(after)).any(dim=1)
        full = full.cpu().numpy()
        _, touched = before.apply_delta(rep.delta)
        mask = analyzer.delta_replan_mask(
            gat.strategy, before.densities(), after.densities(), ones,
            gat.executor.model, touched=touched)
        check(np.array_equal(mask, full) and int(full.sum())
              == rep.replan_cells, f"minibatch stream: delta to "
              f"v{rep.graph_version}: replan mask != two full replans")
        per_delta.append({"graph_version": rep.graph_version,
                          "changed": rep.delta.n_changed,
                          "touched_cells": rep.touched_cells,
                          "replan_cells": rep.replan_cells,
                          "total_cells": rep.total_cells,
                          "cache_invalidated": rep.cache_invalidated,
                          "inflight_at_delta": d_["inflight"],
                          "apply_ms": d_["apply_s"] * 1e3})
    delta_check_s = time.perf_counter() - t0
    s = planner.cache.stats
    sojourn = [((qt.completed_at if qt.completed_at is not None else t_)
                - t_) * 1e3 for qt, t_ in zip(qts, submit_at)]
    cached = sum(qt.from_cache for qt in qts)
    issued = sum(len(qt.tickets) for qt in qts)
    unique = sum(len(dict.fromkeys(qt.seeds)) for qt in qts)
    check(issued == -2 - planner._next_rid and planner.inflight == 0,
          "minibatch stream: issued requests and the planner disagree")
    record("minibatch_stream", card=card, model="gat", heads=2,
           f_in=MB_F_IN, hidden=MB_HIDDEN, classes=MB_CLASSES,
           slots=MB_SLOTS, shed="never", queries=MB_QUERIES,
           seeds=unique, cached_seeds=cached, issued_requests=issued,
           coalesced_seeds=unique - cached - issued,
           delivered_requests=len(delivered), waves=len(srv.dispatch_log),
           cut_reasons=dict(collections.Counter(
               w_.reason for w_ in srv.dispatch_log)),
           deltas=per_delta, store_update_at=MB_UPDATE_AT,
           store_updated_rows=MB_HOT, cache=s.as_dict(),
           resident=len(planner.cache),
           sojourn_ms_p50=float(np.percentile(sojourn, 50)),
           sojourn_ms_p99=float(np.percentile(sojourn, 99)),
           stream_s=stream_s, queries_per_s=MB_QUERIES / stream_s,
           launches_stream=counts, rows_checked=n_rows,
           oracle_runs=len(oracle), oracle_s=oracle_s,
           delta_check_s=delta_check_s, bitwise_oracle=True,
           seconds_b=time.perf_counter() - t_b,
           seconds=time.perf_counter() - t_part)
    del gat, srv, planner, store, features, oracle, graphs
    import gc
    gc.collect()
    torch.cuda.empty_cache()


SIM_DATASETS = ("CI", "CO", "PU", "FL", "NE", "RE")
SIM_MODELS = ("gcn", "sage", "gin", "sgc")
# (strategy, cost model): the four mappings under the paper's FPGA model,
# then Algorithm 7 under the TPU model
SIM_CELLS = (("dynamic", "fpga"), ("s1", "fpga"), ("s2", "fpga"),
             ("gemm", "fpga"), ("dynamic", "tpu"))
SIM_TWIN_THREADS = 6  # threads running the CPU twins after the card pass
SIM_RMAX = 576        # ELL slots of CiteSeer's A_mean, as in phase 2


def simulator_phase(torch, np, K, dev, card, A, H0) -> None:
    """Phase 5f: the cost-model simulator (``build_sim``, ``simulate``)
    planning on the card.

    (a) every Table VI graph at full scale with GCN, GraphSAGE, GIN and SGC:
    ``dynamic``, ``s1``, ``s2`` and ``gemm`` under the FPGA model and
    ``dynamic`` under the TPU model, each held to the same call with
    ``device="cpu"`` in this process (the CPU twins run in
    ``SIM_TWIN_THREADS`` threads after the card pass):
    histograms and every kernel's makespan equal.  The reference's
    simulator gates: dynamic <= 1.02 x min(s1, s2) for GCN and SAGE on CI,
    ``s2`` never SKIPs, K2P time linear in the decisions, and the SO-S1
    trend under weight pruning on PubMed rising.  The modeled figures are
    the Alveo U250 cost model's latencies, not times of the card.  (b) the
    flat formats on CiteSeer's A_mean on the card equal the CPU's, their
    round trips are exact, ``csr_to_ell`` equals ``dense_to_ell`` and
    ``csr_spmm`` over it equals the ELL route bitwise.  (c)
    ``block_tile_density`` through ``tile_nnz`` equals the CPU's."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import hw
    from repro_torch.core import analyzer, formats, profiler, runtime
    from repro_torch.core.perf_model import FPGACostModel, TPUCostModel
    from repro_torch.kernels import ops
    from repro_torch.models import gnn
    t_phase = time.perf_counter()
    freq = hw.ALVEO_U250.freq_hz
    cost = {"fpga": FPGACostModel(), "tpu": TPUCostModel()}
    fpga_ms = lambda rep: rep.total_seconds(freq) * 1e3     # noqa: E731

    def plan_on_card(sim):
        """The dynamic FPGA plan of every kernel, densities uploaded and
        codes left on the card (what ``simulate`` runs there)."""
        for k in sim.compiled.graph.topo_order():
            dx, dy = runtime._operand_block_densities(k, sim.stats)
            analyzer.plan_codes(
                "dynamic",
                torch.from_numpy(np.asarray(dx, np.float32)).to(dev),
                torch.from_numpy(np.asarray(dy, np.float32)).to(dev),
                cost["fpga"], kernel_type=k.kernel_type, source_order=True)

    # (a) the card pass, timed per call, then the CPU twins
    K.reset_launch_counts()
    sims, card_reps, walls, builds, plan_ms = {}, {}, {}, {}, {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for ds in SIM_DATASETS:
        for model in SIM_MODELS:
            key = (ds, model)
            t = time.perf_counter()
            sims[key] = sim = gnn.build_sim(model, ds, device=dev)
            builds[key] = time.perf_counter() - t
            reps, ws = [], []
            for strategy, m in SIM_CELLS:
                t = time.perf_counter()
                reps.append(sim.simulate(strategy, model=cost[m]))
                ws.append((time.perf_counter() - t) * 1e3)
            card_reps[key], walls[key] = reps, ws
            torch.cuda.synchronize()
            start.record()
            plan_on_card(sim)
            end.record()
            torch.cuda.synchronize()
            plan_ms[key] = start.elapsed_time(end)
    card_s = time.perf_counter() - t_phase
    sim_counts = K.launch_counts()
    check(not any(sim_counts.values()),
          f"the simulator launched a kernel of the port: {sim_counts}")
    # the planning's device time on the pair with the most decisions,
    # while this thread has the host to itself
    biggest = max(sims, key=lambda k: int(card_reps[k][0].histogram.sum()))
    prof = profile_device(torch, lambda: plan_on_card(sims[biggest]), n=3)
    t = time.perf_counter()
    so_pruned = []
    for dens in (1.0, 0.3, 0.05):
        sim = gnn.build_sim("gcn", "PU", weight_density=dens, device=dev)
        so_pruned.append(sim.simulate("s1").total_cycles
                         / sim.simulate("dynamic").total_cycles)
    check(so_pruned[0] < so_pruned[1] < so_pruned[2],
          f"SO-S1 under pruning on PU does not rise: {so_pruned}")
    pruning_s = time.perf_counter() - t

    # the CPU twins and the CPU references of (b) and (c) run in threads
    # while this thread drives (b) and (c) on the card, in a launch window
    # of their own (the CPU threads launch nothing)
    t = time.perf_counter()
    A_cpu = A.cpu()
    tile_block = ((128, 128), (16, 16))
    with ThreadPoolExecutor(max_workers=SIM_TWIN_THREADS) as ex:
        twins = {key: [ex.submit(runtime.simulate_inference, sim.compiled,
                                 sim.stats, strategy=s, model=cost[m],
                                 device="cpu") for s, m in SIM_CELLS]
                 for key, sim in sims.items()}
        refs = ex.submit(lambda: (
            formats.dense_to_coo(A_cpu), formats.dense_to_csr(A_cpu),
            profiler.block_tile_density(A_cpu, *tile_block)))
        K.reset_launch_counts()
        coo, csr = formats.dense_to_coo(A), formats.dense_to_csr(A)
        trips = (formats.coo_to_dense(coo), formats.csr_to_dense(csr))
        via = formats.csr_to_ell(csr, SIM_RMAX)
        direct = formats.dense_to_ell(A, SIM_RMAX)
        got = K.csr_spmm.csr_spmm(via.values, via.cols, via.row_counts, H0)
        want = ops.csr_spmm(A, H0, rmax=SIM_RMAX)
        btd = profiler.block_tile_density(A, *tile_block)
        torch.cuda.synchronize()
        fmt_counts = K.launch_counts()
        coo_h, csr_h, btd_cpu = refs.result()
        cpu_reps = {key: [f.result() for f in fs]
                    for key, fs in twins.items()}
    overlap_s = time.perf_counter() - t

    decisions = 0
    for key, reps in card_reps.items():
        for (strategy, m), got_r, want_r in zip(SIM_CELLS, reps,
                                                cpu_reps[key]):
            what = f"simulate {key} {strategy}/{m}"
            check([k.name for k in got_r.kernels]
                  == [k.name for k in want_r.kernels], what)
            for gk, wk in zip(got_r.kernels, want_r.kernels):
                check(np.array_equal(gk.histogram, wk.histogram)
                      and gk.makespan_cycles == wk.makespan_cycles,
                      f"{what} {gk.name}: card {gk.histogram.tolist()} "
                      f"{gk.makespan_cycles} != cpu {wk.histogram.tolist()} "
                      f"{wk.makespan_cycles}")
                decisions += int(gk.histogram.sum())
            if strategy == "s2":
                check(got_r.histogram[0] == 0, f"{what}: s2 skipped")
            ratios = [k.k2p_seconds / int(k.histogram.sum())
                      for k in got_r.kernels]
            check(max(ratios) - min(ratios) < 1e-12,
                  f"{what}: K2P time not linear in the decisions")
    for model in ("gcn", "sage"):
        lat = {s: r.total_cycles for (s, m), r
               in zip(SIM_CELLS, card_reps[("CI", model)]) if m == "fpga"}
        check(lat["dynamic"] <= min(lat["s1"], lat["s2"]) * 1.02,
              f"dynamic does not dominate the static mappings on CI/{model}")
    so1, so2 = [], []
    for key, reps in card_reps.items():
        ms = {s: fpga_ms(r) for (s, m), r in zip(SIM_CELLS, reps)
              if m == "fpga"}
        so1.append(ms["s1"] / ms["dynamic"])
        so2.append(ms["s2"] / ms["dynamic"])
        record("simulator_pair", dataset=key[0], model=key[1], card=card,
               modeled_u250_ms=ms, so_s1=so1[-1], so_s2=so2[-1],
               tpu_model_dynamic_s=reps[-1].total_cycles,
               histograms={f"{s}/{m}": r.histogram.tolist()
                           for (s, m), r in zip(SIM_CELLS, reps)},
               host_wall_ms={f"{s}/{m}": w
                             for (s, m), w in zip(SIM_CELLS, walls[key])},
               build_s=builds[key], plan_event_ms=plan_ms[key])
    record("simulator_table7", card=card, pairs=len(card_reps),
           cells=len(SIM_CELLS), decisions=decisions,
           geomean_so_s1=float(np.exp(np.mean(np.log(so1)))),
           geomean_so_s2=float(np.exp(np.mean(np.log(so2)))),
           so_s1_pruned_pu_gcn=so_pruned,
           host_wall_ms_total=sum(sum(w) for w in walls.values()),
           plan_event_ms_total=sum(plan_ms.values()),
           plan_profile={"pair": list(biggest), **prof},
           card_pass_s=card_s, pruning_s=pruning_s,
           twins_and_formats_s=overlap_s, cpu_twin_threads=SIM_TWIN_THREADS,
           note="modeled_u250_ms are Alveo U250 cost-model latencies "
                "(Table IV model, 250 MHz), not times of the card")

    # (b), (c): the card's formats against the CPU's
    for name, got_f, want_f in (
            [(f"coo.{f}", getattr(coo, f), getattr(coo_h, f))
             for f in ("rows", "cols", "values", "nnz")]
            + [(f"csr.{f}", getattr(csr, f), getattr(csr_h, f))
               for f in ("indptr", "indices", "values")]
            + [("coo_to_dense", trips[0], A_cpu),
               ("csr_to_dense", trips[1], A_cpu),
               ("block_tile_density", btd, btd_cpu)]):
        check(got_f.dtype == want_f.dtype
              and torch.equal(got_f.cpu(), want_f),
              f"{name}: the card's differs from the CPU's")
    for f in ("values", "cols", "row_counts"):
        check(torch.equal(getattr(via, f), getattr(direct, f)),
              f"csr_to_ell {f} != dense_to_ell's")
    check(torch.equal(got, want),
          "csr_spmm over csr_to_ell != the ELL route, bitwise")
    check(fmt_counts["csr_spmm"] >= 2 and fmt_counts["tile_nnz"] >= 1,
          f"phase 5f formats launched {fmt_counts}")
    record("simulator_formats", card=card, shape=list(A.shape),
           nnz=int(coo.nnz), capacity=coo.capacity, rmax=SIM_RMAX,
           coo_csr_equal_cpu=True, round_trips_exact=True,
           csr_to_ell_equals_dense_to_ell=True,
           csr_spmm_equals_ell_route=True,
           block_tile_density_shape=list(btd.shape),
           block_tile_density_mean=float(btd_cpu.mean()),
           block_tile_density_equal_cpu=True, launches=fmt_counts)
    del coo, coo_h, csr, csr_h, trips, via, direct, got, want, A_cpu
    torch.cuda.empty_cache()
    record("simulator_phase", card=card,
           seconds=time.perf_counter() - t_phase)


LM_ARCH = "llama3.2-1b"
SCORE_BATCH, SCORE_SEQ = 2, 2048
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 128, 16
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_DENSITY = 4, 144, 0.1
# the bf16 (tensor-core) dispatch kernel's entry in the kernels line: its
# launches are every dispatch launch of the serving path (prefill and
# decode; w1, w2 and w3), its times those of the most frequent call, a
# decode step's FFN w1 product
LM_DISPATCH = "dispatch (bf16, tensor cores)"
LM_FLASH_F32 = "flash_attention (float32)"
BWD_F32 = "dispatch_bwd (float32)"
# the float32 training forward on the tiled kernel (dispatch.block_matmul_nn,
# counted under dispatch): its launches are the float32 step window's
FWD_F32 = "dispatch (float32, tiled forward)"
# the two float32 forward kernels as the profiler names them
NN_KERNEL = "dispatch_bwd_f32_kernel<2,"
WALK_KERNEL = "dispatch_fma_kernel"


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def rel_err(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


# phase 5g: multi-device wave dispatch.  The card's machine holds ONE H100,
# so (a) is a real one-card mesh and (b)/(c) run EMULATED lanes
# (cores_mesh(4, device=cuda:0)): the same per-lane walks, placements and
# group plans as four cards, one lane after another on the one card, so
# their walls measure no multi-device speed
SHARD_LANES = 4


def sharded_phase(torch, np, K, dev, card) -> None:
    """Phase 5g: multi-device wave dispatch (``mesh=``, ``submesh=``,
    ``resize``/``autoscale``).

    (a) SAGE at CiteSeer's widths (phase 5c (b)'s requests) on
    ``cores_mesh(1)``, the real card: serve == the unsharded engine's
    serve == run_naive bitwise, ``wave_lanes`` 1, one walk plan per bucket,
    the same launch counts per serve; (b) the same requests on 4 emulated
    lanes, one slot each, and through the groups of a ``[2, 1, 1]``
    partition (``begin_wave(submesh=...)``), then the reference's serving
    stream for SAGE under ``s1`` and GCN on the row-CSR route (``spdmm``
    and ``csr_spmm`` across the lane split): == run_naive bitwise,
    ``tile_nnz_batched`` launches == lanes x request inputs per wave, one
    walk plan per (bucket, group size); (c) the scripted stream
    (``tests/torch_scripted_stream.py``) through a ``resize=True,
    autoscale=True`` server on 4 emulated lanes, on the card and on the
    CPU: equal dispatch logs, group plans, ``last_auto_lanes`` and
    tickets, == run_naive bitwise.  Records the wave walls per lane count
    (``emulated`` where they are) and the device busy time."""
    from repro_torch.core import runtime
    from repro_torch.core.perf_model import TPUCostModel
    from repro_torch.distributed import sharding
    from repro_torch.serving.graph_engine import (GraphServeEngine,
                                                  random_requests)
    from repro_torch.serving.scheduler import ContinuousGraphServer
    t_phase = time.perf_counter()

    def inputs(eng, bucket):
        flows = runtime.FusedModelExecutor._resolved_flows(
            eng._compiled[bucket])
        return len([n_ for n_, _ in runtime.FusedModelExecutor
                    ._needed_inputs(flows) if n_ in eng._input_names[bucket]])

    def log_waves(eng):
        """(bucket, lanes) of every wave the engine begins from now on."""
        waves, begin = [], eng.begin_wave

        def begin_wave(bucket, wave, submesh=None):
            h_ = begin(bucket, wave, submesh=submesh)
            waves.append((bucket, h_.pending.lanes))
            return h_

        eng.begin_wave = begin_wave
        return waves

    def window(fn):
        """``fn()`` between a reset and a read of the launch counts."""
        K.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, K.launch_counts()

    def bitwise(results, naive, label):
        check(sorted(r_.request_id for r_ in results) == sorted(naive),
              f"{label}: not every request served once")
        for r_ in results:
            check(np.array_equal(r_.logits, naive[r_.request_id]),
                  f"{label}: request {r_.request_id} != run_naive")

    def batched_ok(eng, waves, counts, label):
        want = sum(lanes * inputs(eng, b_) for b_, lanes in waves)
        check(counts["tile_nnz_batched"] == want,
              f"{label}: {counts['tile_nnz_batched']} tile_nnz_batched "
              f"launches, lanes x request inputs per wave make {want}")
        pairs = {(b_, lanes) for b_, lanes in waves}
        check(eng.executor.trace_count <= len(pairs),
              f"{label}: {eng.executor.trace_count} walk plans for "
              f"{len(pairs)} (bucket, group size) pairs")

    def wave_walls(eng, fn, n=2):
        eng.bucket_walls, eng.group_walls = {}, {}
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        walls = [w_ for ws in eng.group_walls.values() for w_ in ws]
        return statistics.median(walls) * 1e3

    # ---- (a) a real one-card mesh ---------------------------------------
    t_part = time.perf_counter()
    reqs = random_requests(CI_REQUESTS, f_in=CI_F_IN, sizes=CI_SIZES, seed=0,
                           avg_degree=CI_DEGREE, feat_density=CI_FEAT)
    kw = dict(f_in=CI_F_IN, hidden=16, n_classes=CI_CLASSES, slots=4,
              min_bucket=64)
    plain = GraphServeEngine("sage", device=dev, **kw)
    one = GraphServeEngine("sage", mesh=sharding.cores_mesh(1), **kw)
    check(one.mesh.devices == (plain.weights["Wself1"].device,)
          and one.lanes == 1, f"cores_mesh(1) is {one.mesh}")
    naive = {r_.request_id: r_.logits for r_ in plain.run_naive(reqs)}
    plain.serve(reqs)
    one.serve(reqs)
    p_res, p_counts = window(lambda: plain.serve(reqs))
    o_waves = log_waves(one)
    o_res, o_counts = window(lambda: one.serve(reqs))
    o_waves = list(o_waves)
    bitwise(p_res, naive, "unsharded serve")
    bitwise(o_res, naive, "one-card mesh")
    check(one.last_wave_report.wave_lanes == 1
          and all(lanes == 1 for _, lanes in o_waves),
          "one-card mesh: a wave ran on more than one lane")
    check(one.executor.trace_count == len(one.buckets) == len(CI_BUCKETS),
          f"one-card mesh: {one.executor.trace_count} walk plans for "
          f"{len(one.buckets)} buckets")
    check(o_counts == p_counts, f"one-card mesh launched {o_counts}, "
          f"the unsharded engine {p_counts}")
    batched_ok(one, o_waves, o_counts, "one-card mesh")
    walls = {"unsharded": wave_walls(plain, lambda: plain.serve(reqs)),
             "1 (card)": wave_walls(one, lambda: one.serve(reqs))}
    record("sharded_one_card", card=card, model="sage", requests=len(reqs),
           buckets=one.buckets, waves=len(o_waves), launches=o_counts,
           equal_unsharded_launches=True, bitwise_naive=True,
           bitwise_unsharded=True, traces=one.executor.trace_count,
           seconds=time.perf_counter() - t_part)
    del one, p_res, o_res

    # ---- (b) emulated lanes on the one card -----------------------------
    t_part = time.perf_counter()
    mesh = sharding.cores_mesh(SHARD_LANES, device=dev)
    check(mesh.devices == (mesh.devices[0],) * SHARD_LANES, f"mesh {mesh}")
    four = GraphServeEngine("sage", mesh=mesh, **kw)
    four.serve(reqs)
    f_waves = log_waves(four)
    f_res, f_counts = window(lambda: four.serve(reqs))
    f_waves = list(f_waves)
    bitwise(f_res, naive, "4 emulated lanes")
    check(four.last_wave_report.wave_lanes == SHARD_LANES
          and all(lanes == SHARD_LANES for _, lanes in f_waves),
          "4 emulated lanes: a wave on another lane count")
    for name in ("tile_nnz_batched", "dispatch"):
        check(f_counts[name] > 0, f"4 emulated lanes never launched {name}")
    # the [2, 1, 1] groups each run the first wave of the smallest bucket
    groups = sharding.partition_mesh(mesh, [2, 1, 1])
    g_bucket = CI_BUCKETS[0]
    g_reqs = [r_ for r_ in reqs if four.bucket_for(r_.n_vertices)
              == g_bucket][:4]
    g_waves = log_waves(four)
    g_res, g_counts = window(lambda: [
        r_ for g_ in groups for r_ in four.finish_wave(
            four.begin_wave(g_bucket, g_reqs, submesh=g_))])
    g_waves = list(g_waves)
    check(len(g_res) == len(groups) * len(g_reqs) > 0,
          f"[2, 1, 1] groups served {len(g_res)} results")
    for r_ in g_res:
        check(np.array_equal(r_.logits, naive[r_.request_id]),
              f"[2, 1, 1] groups: request {r_.request_id} != run_naive")
    check(sorted({lanes for _, lanes in g_waves}) == [1, 2],
          f"[2, 1, 1] groups ran on {g_waves}")
    batched_ok(four, f_waves + g_waves, {
        "tile_nnz_batched": f_counts["tile_nnz_batched"]
        + g_counts["tile_nnz_batched"]}, "4 emulated lanes and groups")
    walls[f"{SHARD_LANES} (emulated)"] = wave_walls(
        four, lambda: four.serve(reqs))
    busy = {}
    for label, eng in (("unsharded", plain),
                       (f"{SHARD_LANES} (emulated)", four)):
        prof = profile_device(torch, lambda: eng.serve(reqs), n=1, top=6)
        busy[label] = {k_: prof[k_] for k_ in (
            "device_busy_ms", "idle_share", "wall_ms_profiled", "complete")}
    del f_res, g_res
    stream = []
    sreqs = random_requests(STREAM_REQUESTS, f_in=STREAM_F_IN,
                            sizes=STREAM_SIZES, seed=STREAM_SEED)
    cheap = dataclasses.replace(TPUCostModel(), eff_transform=1.0,
                                transform_overhead_s=0.0)
    for model, strategy, cost, need in (
            ("sage", "s1", None, "spdmm"),
            ("gcn", "dynamic", cheap, "csr_spmm")):
        label = f"{model} {strategy}" + (" CSR" if cost else "") + \
            f" on {SHARD_LANES} emulated lanes"
        eng = GraphServeEngine(model, f_in=STREAM_F_IN, hidden=16,
                               n_classes=7, slots=STREAM_SLOTS, weight_seed=0,
                               strategy=strategy, cost_model=cost, mesh=mesh)
        waves = log_waves(eng)
        res, counts = window(lambda: eng.serve(sreqs))
        waves = list(waves)
        bitwise(res, {r_.request_id: r_.logits
                      for r_ in eng.run_naive(sreqs)}, label)
        check(counts[need] > 0, f"{label}: {need} never ran")
        batched_ok(eng, waves, counts, label)
        check(eng.executor.trace_count == len(eng.buckets),
              f"{label}: {eng.executor.trace_count} walk plans for "
              f"{len(eng.buckets)} buckets")
        stream.append({"run": label, "waves": len(waves),
                       "buckets": eng.buckets, "launches": counts,
                       "bitwise_naive": True})
        del eng
    record("sharded_emulated", card=card, lanes=SHARD_LANES, emulated=True,
           model="sage", requests=len(reqs), launches=f_counts,
           groups=[2, 1, 1], group_launches=g_counts,
           group_waves=[list(w_) for w_ in g_waves],
           traces=four.executor.trace_count, stream=stream,
           bitwise_naive=True, seconds=time.perf_counter() - t_part)
    record("sharded_walls", card=card, model="sage", requests=len(reqs),
           wave_wall_p50_ms=walls, device=busy,
           note="emulated lanes run one after another on one card")
    del four, plain

    # ---- (c) resize continuous serving, scripted ------------------------
    t_part = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_scripted_stream as scripted
    sreqs = random_requests(scripted.N_STREAM, f_in=32,
                            sizes=scripted.STREAM_SIZES,
                            seed=scripted.STREAM_SEED)
    runs = []
    for where in (dev, "cpu"):
        eng = GraphServeEngine("gcn", f_in=32, hidden=8, n_classes=6,
                               slots=SHARD_LANES, min_bucket=32,
                               mesh=sharding.cores_mesh(SHARD_LANES,
                                                        device=where))
        clk = scripted.stream_clock()
        scripted.script_walls(eng, clk)
        srv = ContinuousGraphServer(eng, clock=clk, resize=True,
                                    autoscale=True, **scripted.SERVER_KW,
                                    **scripted.POLICIES["never"])
        plans, dispatch = [], srv._dispatch_groups

        def dispatch_groups(ready, srv=srv, plans=plans, dispatch=dispatch):
            out = dispatch(ready)
            plans.append((list(srv.last_group_sizes), srv.last_auto_lanes))
            return out

        srv._dispatch_groups = dispatch_groups
        srv.warmup((20,))
        (tickets, done), counts = window(lambda: scripted.stream(
            srv, clk, sreqs, np.random.default_rng(3)))
        del eng.finish_wave
        runs.append((eng, srv, plans, tickets, done, counts))
    (eng, srv, plans, tickets, done, counts), (_, c_srv, c_plans, c_tickets,
                                               c_done, _) = runs

    def wave_log(s_):
        return [(w_.bucket, w_.n_real, w_.reason, w_.cut_at, w_.wall,
                 w_.lane, w_.group_size, w_.classes) for w_ in s_.dispatch_log]

    check(wave_log(srv) == wave_log(c_srv), "resize: dispatch log differs "
          "from the CPU's")
    check(plans == c_plans, "resize: group plans or autoscaled lane counts "
          "differ from the CPU's")
    check([(int(t_), t_.verdict, t_.bucket, t_.predicted_wall)
           for t_ in tickets] == [(int(t_), t_.verdict, t_.bucket,
                                   t_.predicted_wall) for t_ in c_tickets],
          "resize: tickets differ from the CPU's")
    check(len({w_.group_size for w_ in srv.dispatch_log}) > 1
          and any(k_ is not None for _, k_ in plans),
          f"resize: no group was resized ({plans})")
    shed = {int(t_) for t_ in srv.shed_log}
    bitwise(done, {r_.request_id: r_.logits for r_ in eng.run_naive(
        [r_ for r_, t_ in zip(sreqs, tickets) if int(t_) not in shed])},
        "resize")
    for a_, b_ in zip(done, c_done):
        check(bool(np.allclose(a_.logits, b_.logits, atol=TOL, rtol=TOL)),
              f"resize: card logits vs CPU beyond {TOL}")
    for name in ("tile_nnz_batched", "dispatch"):
        check(counts[name] > 0, f"resize stream never launched {name}")
    record("sharded_resize", card=card, lanes=SHARD_LANES, emulated=True,
           requests=len(sreqs), waves=len(srv.dispatch_log),
           log=[[w_.bucket, w_.n_real, w_.reason, w_.lane, w_.group_size]
                for w_ in srv.dispatch_log],
           plans=plans, last_auto_lanes=srv.last_auto_lanes,
           launches=counts, equal_cpu=True, bitwise_naive=True,
           seconds=time.perf_counter() - t_part)
    record("sharded_phase", card=card,
           seconds=time.perf_counter() - t_phase)


def lm_paths(torch, np, K, dev, card, A, kernel_entry, small_checks) -> dict:
    """Phases 7-9: the LM kernels against their plain versions at the LM
    paths' shapes; the full-width scoring path (flash); the full-width
    serving path, dynasparse and dense; the smoke config's invariants.
    Returns each path window's launch counts."""
    import dataclasses

    import torch.nn.functional as F
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.core import analyzer, dynasparse, profiler
    from repro_torch.core.perf_model import TPUCostModel
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import prune_ffn
    from repro_torch.models import layers, model_zoo, transformer
    from repro_torch.serving.engine import Request, ServeEngine

    replace = dataclasses.replace
    counts = {}
    cfg = get_arch(LM_ARCH)
    flash_cfg = replace(cfg, attn_impl="flash")
    chunked_cfg = replace(cfg, attn_impl="chunked")
    t0 = time.perf_counter()
    score_bundle = model_zoo.build(flash_cfg, device=dev)
    params = score_bundle.init_params(0)
    # scoring reads the unpruned weights, serving the pruned copy of the FFN
    pruned = prune_ffn({**params, "layers": [
        {**lp, "ffn": {k: w.clone() for k, w in lp["ffn"].items()}}
        for lp in params["layers"]]}, SERVE_DENSITY, period=cfg.layer_period)
    torch.cuda.synchronize()
    record("lm_bundle", arch=cfg.name, n_layers=cfg.n_layers,
           d_model=cfg.d_model, n_heads=cfg.n_heads,
           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_, d_ff=cfg.d_ff,
           vocab=cfg.vocab_size, dtype=cfg.dtype,
           params=sum(t.numel() for t in leaves(params)),
           ffn_density_after_prune=float(
               sum(int(torch.count_nonzero(lp["ffn"][w]))
                   for lp in pruned["layers"] for w in ("w1", "w2", "w3"))
               / sum(lp["ffn"][w].numel()
                     for lp in pruned["layers"] for w in ("w1", "w2", "w3"))),
           seconds=time.perf_counter() - t0)

    # ---------------- phase 7: the LM kernels vs their plain versions -----
    w1 = pruned["layers"][0]["ffn"]["w1"]            # (2048, 8192) bf16
    w2 = pruned["layers"][0]["ffn"]["w2"]            # (8192, 2048) bf16

    def nnz_work(x, tile):
        mb, nb = -(-x.shape[0] // tile[0]), -(-x.shape[1] // tile[1])
        return float(x.numel()), float(x.numel() * x.element_size()
                                       + 4 * mb * nb)

    kernel_entry(
        "tile_nnz", "src/repro_torch/kernels/csrc/tile_nnz.cu",
        "src/repro/kernels/profile.py:25",
        lambda: K.profile.tile_nnz(w1, (256, 256)),
        lambda: K.profile.tile_nnz_plain(w1, (256, 256)),
        lambda: torch.count_nonzero(w1.view(8, 256, 32, 256), dim=(1, 3)),
        nnz_work(w1, (256, 256)), lambda g, w: True, units="simt",
        lib_call="torch.count_nonzero(w1.view(8, 256, 32, 256), "
                 "dim=(1, 3))")
    ragged = A[:1000, :777].to(torch.bfloat16)
    small_checks("tile_nnz", [
        ("A_mean 3327x3327 f32 at (64, 16)",
         lambda: K.profile.tile_nnz(A, (64, 16)),
         lambda: K.profile.tile_nnz_plain(A, (64, 16))),
        ("FFN w2 8192x2048 bf16 at (16, 16)",
         lambda: K.profile.tile_nnz(w2, (16, 16)),
         lambda: K.profile.tile_nnz_plain(w2, (16, 16))),
        ("A_mean[:1000, :777] bf16 (strided) at (48, 80)",
         lambda: K.profile.tile_nnz(ragged, (48, 80)),
         lambda: K.profile.tile_nnz_plain(ragged, (48, 80)))])
    record("tile_nnz_total", case="A_mean (64, 16)",
           equals_count_nonzero=int(K.profile.tile_nnz(A, (64, 16)).sum())
           == int(torch.count_nonzero(A)))

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def qkv(b, h, hkv, sq, skv, d, dtype):
        return (torch.randn((b, h, sq, d), generator=gen, device=dev,
                            dtype=dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev,
                            dtype=dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev,
                            dtype=dtype))

    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = qkv(SCORE_BATCH, h, hkv, SCORE_SEQ, SCORE_SEQ, hd,
                  torch.bfloat16)
    pairs = SCORE_BATCH * h * SCORE_SEQ * (SCORE_SEQ + 1) / 2
    torch_version = tuple(int(p) for p in
                          torch.__version__.split("+")[0].split(".")[:2])
    if torch_version >= (2, 5):
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    else:
        kr = k.repeat_interleave(h // hkv, 1)
        vr = v.repeat_interleave(h // hkv, 1)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kr, vr, is_causal=True)
    kernel_entry(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:75",
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: K.flash_attention.flash_attention_plain(
            q, k, v, causal=True, bq=min(128, SCORE_SEQ),
            bk=min(128, SCORE_SEQ)),
        lib, (4.0 * hd * pairs,
              2.0 * (2 * q.numel() + k.numel() + v.numel())),
        lambda g, w: float((g.float() - w.float()).abs().max())
        < FLASH_TOL * float(w.float().abs().max()),
        tol=FLASH_TOL, peak=PEAK_BF16, units="mma")
    want = K.flash_attention.flash_attention_plain(
        q, k, v, causal=True, bq=min(128, SCORE_SEQ),
        bk=min(128, SCORE_SEQ)).float().abs()
    record("flash_scale", mean_abs_want=float(want.mean()),
           median_abs_want=float(want.flatten()[::97].median()),
           max_abs_want=float(want.max()), tol=FLASH_TOL)
    del want
    record("flash_vs_library",
           max_abs_err=float((ops.flash_attention(q, k, v, causal=True)
                              .float() - lib().float()).abs().max()))
    # the float32 route (FMA units) at the scoring shape, beside SDPA in
    # float32: the float32 scoring path of phase 8 launches it
    q32, k32, v32 = (t_.float() for t_ in (q, k, v))
    kr32 = k32.repeat_interleave(h // hkv, 1)
    vr32 = v32.repeat_interleave(h // hkv, 1)
    kernel_entry(
        LM_FLASH_F32, "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:75",
        lambda: ops.flash_attention(q32, k32, v32, causal=True),
        lambda: K.flash_attention.flash_attention_plain(
            q32, k32, v32, causal=True, bq=min(128, SCORE_SEQ),
            bk=min(128, SCORE_SEQ)),
        lambda: F.scaled_dot_product_attention(q32, kr32, vr32,
                                               is_causal=True),
        (4.0 * hd * pairs, 4.0 * (2 * q.numel() + k.numel() + v.numel())),
        lambda g, w: float((g - w).abs().max())
        <= TOL * float(w.abs().max()),
        lib_call="scaled_dot_product_attention (float32, kv repeated)")
    del q32, k32, v32, kr32, vr32
    # the reference's edge semantics, on the float32 (FMA) route at 3e-4
    # and on the bf16 (tensor-core) route at the bf16 tolerance
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
        cases = []
        for label, shape, causal, bq, bk in (
                ("S=40 front-padded, causal, GQA 4/2, D=64",
                 (2, 4, 2, 40, 40, 64), True, 16, 16),
                ("non-causal, Sq=64 != Skv=128, D=32",
                 (1, 4, 4, 64, 128, 32), False, 128, 128),
                ("causal, Sq=80 > Skv=48 (rows with no key), D=16",
                 (1, 2, 1, 80, 48, 16), True, 16, 16),
                ("causal, Sq=48 > Skv=40, bk=8 (rows averaging masked keys)",
                 (1, 2, 2, 48, 40, 32), True, 16, 8),
                ("causal, D=128, GQA 8/2", (1, 8, 2, 96, 96, 128), True, 32,
                 32)):
            qs, ks, vs = qkv(*shape, dtype)
            kw = dict(causal=causal, bq=bq, bk=bk)
            cases.append((f"{label}, {str(dtype)[6:]}",
                          lambda qs=qs, ks=ks, vs=vs, kw=kw:
                          ops.flash_attention(qs, ks, vs, **kw),
                          lambda qs=qs, ks=ks, vs=vs, kw=kw:
                          ops.flash_attention(qs.cpu(), ks.cpu(), vs.cpu(),
                                              **kw)))
        small_checks("flash_attention", cases, tol=tol)

    # dispatch (bf16, (256, 256, 256)) on a prefill wave's activations and
    # a pruned FFN weight, with the planner's own codes
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    wave0 = torch.from_numpy(np.stack(prompts[:SERVE_SLOTS]).astype(
        np.int64)).to(dev)
    x = layers.rmsnorm(params["embed"][wave0].reshape(-1, cfg.d_model),
                       pruned["layers"][0]["ln2"]["scale"])
    blk = layers.FFN_BLOCK
    # w2's input is the FFN hidden state of the same rows (d_ff wide)
    w3 = pruned["layers"][0]["ffn"]["w3"]
    hid = F.silu(x @ w1) * (x @ w3)
    # (called as the FFN calls it, for x's rows only: pad_rows=False)
    for label, xs, w, suffix in (
            ("prefill", x, w1, ""), ("decode", x[:SERVE_SLOTS], w1, ""),
            ("prefill", hid, w2, ", w2"),
            ("decode", hid[:SERVE_SLOTS], w2, ", w2")):
        codes = analyzer.plan_codes(
            "dynamic", profiler.block_density(xs, blk[:2]),
            profiler.block_density(w, blk[1:]), TPUCostModel())
        name = f"dispatch (bf16, 256, {label} {xs.shape[0]} rows{suffix})"
        kernel_entry(
            name, "src/repro_torch/kernels/csrc/dispatch.cu",
            "src/repro/core/dynasparse.py:239",
            lambda xs=xs, w=w, codes=codes:
            K.dispatch.block_matmul(xs, w, codes, blk, pad_rows=False),
            lambda xs=xs, w=w, codes=codes:
            K.dispatch.block_matmul_plain(xs, w, codes, blk, pad_rows=False),
            lambda xs=xs, w=w: torch.matmul(xs, w),
            dispatch_work(torch, K, xs, w, codes, blk), lambda g, w: True,
            tol=DISPATCH_BF16_TOL, peak=PEAK_BF16,
            line=(label, suffix) == ("decode", ""), line_name=LM_DISPATCH,
            units="mma")
        shape = K.dispatch.mma_launch(xs.shape[0], *codes.shape, blk)
        record("dispatch_codes", case=f"{label}{suffix}", rows=xs.shape[0],
               padded_rows=codes.shape[0] * blk[0],
               histogram=torch.bincount(codes.flatten().long(),
                                        minlength=4).tolist(),
               launch=dataclasses.asdict(shape),
               ctas=shape.row_ctas * shape.col_ctas * shape.splits)
    crng = np.random.default_rng(4)
    cases = []
    for b_, (xs, ys) in (((256, 256, 256), (x[:300], w1[:, :600])),
                         ((128, 64, 256), (x[:200], w1[:, :300])),
                         ((256, 32, 32), (x[:260], w1[:, :100]))):
        c = torch.from_numpy(crng.integers(0, 4, size=(
            -(-xs.shape[0] // b_[0]), -(-ys.shape[1] // b_[2]),
            -(-xs.shape[1] // b_[1]))).astype(np.int32)).to(dev)
        cases.append((f"bf16 random codes {b_} {tuple(xs.shape)}x"
                      f"{tuple(ys.shape)}",
                      lambda xs=xs, ys=ys, c=c, b_=b_:
                      K.dispatch.block_matmul(xs, ys, c, b_),
                      lambda xs=xs, ys=ys, c=c, b_=b_:
                      K.dispatch.block_matmul_plain(xs, ys, c, b_)))
    # decode-sized row counts: one 16-row tile (m = 1, 4), two (17), a
    # ragged 128-row tile (300); each split over w1's k-blocks, padded
    # and (as the FFN calls it) x's rows only
    for m in (1, 4, 17, 300):
        c = torch.from_numpy(crng.integers(0, 4, size=(
            1 if m <= 256 else 2, w1.shape[1] // 256,
            w1.shape[0] // 256)).astype(np.int32)).to(dev)
        for pad in (True, False):
            cases.append((
                f"bf16 random codes (256, 256, 256) decode m={m} x w1"
                f"{'' if pad else ', pad_rows=False'}",
                lambda m=m, c=c, pad=pad: K.dispatch.block_matmul(
                    x[:m], w1, c, blk, pad_rows=pad),
                lambda m=m, c=c, pad=pad: K.dispatch.block_matmul_plain(
                    x[:m], w1, c, blk, pad_rows=pad)))
    small_checks("dispatch", cases, tol=DISPATCH_BF16_TOL)

    # ---------------- phase 8: LM scoring, full width, flash --------------
    rng = np.random.default_rng(0)
    batch = {k_: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SCORE_BATCH, SCORE_SEQ))).to(dev)
        for k_ in ("tokens", "labels")}
    with torch.inference_mode():
        K.reset_launch_counts()
        loss = score_bundle.loss_fn(params, batch)
        torch.cuda.synchronize()
        counts["score"] = K.launch_counts()
        loss_flash = float(loss)
        h_flash = transformer.forward(flash_cfg, params, batch["tokens"])[0]
        h_chunk = transformer.forward(chunked_cfg, params,
                                      batch["tokens"])[0]
        hidden_rel = rel_err(torch, h_flash, h_chunk)
        loss_chunk = float(transformer.loss_fn(chunked_cfg, params, batch))
        del h_flash, h_chunk
    record("lm_score_launches", counts=counts["score"])
    check(counts["score"]["flash_attention"] == cfg.n_layers,
          f"scoring forward launched flash {counts['score']} times, "
          f"expected {cfg.n_layers}")
    check(np.isfinite(loss_flash), f"scoring loss {loss_flash}")
    check(hidden_rel < LM_REL, f"flash vs chunked hidden rel {hidden_rel}")
    check(abs(loss_flash - loss_chunk) < LOSS_TOL,
          f"flash loss {loss_flash} vs chunked {loss_chunk}")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        score_ms = {impl: wall_ms(torch, lambda c=c: transformer.loss_fn(
            c, params, batch)) for impl, c in (("flash", flash_cfg),
                                                ("chunked", chunked_cfg))}
        peak = torch.cuda.max_memory_allocated()
    record("lm_score", arch=cfg.name, batch=SCORE_BATCH, seq=SCORE_SEQ,
           loss_flash=loss_flash, loss_chunked=loss_chunk,
           hidden_rel_err_flash_vs_chunked=hidden_rel,
           flash_launches_per_forward=counts["score"]["flash_attention"])
    for impl, ms in score_ms.items():
        record("wall", path="lm_score", arch=cfg.name, attn_impl=impl,
               batch=SCORE_BATCH, seq=SCORE_SEQ, median_ms=ms,
               seconds_per_batch=ms / 1e3,
               tokens_per_s=SCORE_BATCH * SCORE_SEQ / (ms / 1e3),
               peak_memory_bytes=peak, card=card)
    counts["score_f32"] = score_f32(torch, cfg, batch, dev, card)

    # ---------------- phase 9: LM serving, full width ---------------------
    ds_bundle = model_zoo.build(replace(cfg, dynasparse_ffn=True), device=dev)
    dense_bundle = model_zoo.build(cfg, device=dev)
    reqs = [Request(p, max_new_tokens=SERVE_NEW, request_id=i)
            for i, p in enumerate(prompts)]
    engine = {name: ServeEngine(b_, pruned, slots=SERVE_SLOTS,
                                max_seq=SERVE_MAX_SEQ)
              for name, b_ in (("dynasparse", ds_bundle),
                               ("dense", dense_bundle))}
    hist = torch.zeros(4, dtype=torch.int64, device=dev)
    planned = dynasparse.dynasparse_matmul

    def recording(*args, **kw):      # observes the K2P codes of every call
        res = planned(*args, **kw)
        hist.add_(torch.bincount(res.codes.flatten().long(), minlength=4))
        return res

    dynasparse.dynasparse_matmul = recording
    try:
        K.reset_launch_counts()
        res_ds = engine["dynasparse"].generate(reqs)
        torch.cuda.synchronize()
        counts["serve"] = K.launch_counts()
    finally:
        dynasparse.dynasparse_matmul = planned
    record("lm_serve_launches", counts=counts["serve"])
    for name in ("dispatch", "tile_nnz"):
        check(counts["serve"][name] > 0, f"LM serving never launched {name}")
    k2p = hist.tolist()
    check(sum(k2p) > 0 and k2p[1] < sum(k2p),
          f"dynasparse serving K2P histogram {k2p} is all GEMM")
    res_dense = engine["dense"].generate(reqs)
    agree_tok = float(np.mean([np.mean(a.tokens == b_.tokens)
                               for a, b_ in zip(res_ds, res_dense)]))
    with torch.inference_mode():
        first = {name: b_.prefill(pruned, {"tokens": wave0},
                                  max_seq=SERVE_MAX_SEQ)
                 for name, b_ in (("dynasparse", ds_bundle),
                                  ("dense", dense_bundle))}
        first_rel = rel_err(torch, first["dynasparse"][0], first["dense"][0])
        caches = first["dynasparse"][1]
        step = torch.from_numpy(np.array([[int(r.tokens[0])] for r in
                                          res_ds[:SERVE_SLOTS]])).to(dev)
        K.reset_launch_counts()
        ds_bundle.decode_step(pruned, caches, step, SERVE_PROMPT)
        torch.cuda.synchronize()
        counts["decode_step"] = K.launch_counts()
        K.reset_launch_counts()
        ds_bundle.prefill(pruned, {"tokens": wave0}, max_seq=SERVE_MAX_SEQ)
        torch.cuda.synchronize()
        counts["prefill"] = K.launch_counts()
        prof = profile_device(torch, lambda: ds_bundle.decode_step(
            pruned, caches, step, SERVE_PROMPT))
    check(first_rel < LM_REL,
          f"first-step logits dynasparse vs dense rel {first_rel}")
    record("lm_serve", arch=cfg.name, requests=SERVE_REQUESTS,
           prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, slots=SERVE_SLOTS,
           max_seq=SERVE_MAX_SEQ, ffn_density=SERVE_DENSITY,
           k2p_histogram_skip_gemm_spdmm_spmm=k2p,
           first_step_logits_rel_err=first_rel,
           token_agreement_dynasparse_vs_dense=agree_tok,
           launches_per_decode_step=counts["decode_step"],
           launches_per_prefill=counts["prefill"])
    n_tok = SERVE_REQUESTS * SERVE_NEW
    for name, eng in engine.items():
        ms = wall_ms(torch, lambda eng=eng: eng.generate(reqs))
        record("wall", path="lm_serve", arch=cfg.name, engine=name,
               median_ms=ms, tokens=n_tok, tokens_per_s=n_tok / (ms / 1e3),
               card=card)
    record("profile", path="lm_serve", engine="dynasparse",
           what="one decode step (4 slots)", card=card, **prof)
    del engine, first, caches

    # ---------------- phase 9b: the smoke config's invariants on the card -
    small = smoke_config(LM_ARCH, n_layers=2)
    sb = model_zoo.build(small, device=dev)
    sp = prune_ffn(sb.init_params(0), SERVE_DENSITY,
                   period=small.layer_period)
    sb_ds = model_zoo.build(replace(small, dynasparse_ffn=True), device=dev)
    srng = np.random.default_rng(2)
    sreqs = [Request(srng.integers(0, small.vocab_size, 8).astype(np.int32),
                     max_new_tokens=4, request_id=i) for i in range(2)]
    r_dense = ServeEngine(sb, sp, slots=2, max_seq=16).generate(sreqs)
    K.reset_launch_counts()
    r_ds = ServeEngine(sb_ds, sp, slots=2, max_seq=16).generate(sreqs)
    torch.cuda.synchronize()
    small_counts = K.launch_counts()
    equal = all(np.array_equal(a.tokens, b_.tokens)
                for a, b_ in zip(r_dense, r_ds))
    check(small_counts["dispatch"] > 0, "small dynasparse never dispatched")
    check(equal, "smoke config: dynasparse tokens != dense tokens: "
          f"{[r.tokens.tolist() for r in r_ds]} vs "
          f"{[r.tokens.tolist() for r in r_dense]}")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, small.vocab_size, (2, 32))).to(dev)
    decode_rel = {}
    with torch.inference_mode():
        for name, b_ in (("dense", sb), ("dynasparse", sb_ds)):
            full = transformer.forward(b_.cfg, sp, toks)[0]
            want = full[:, -1] @ transformer.lm_head(b_.cfg, sp).T
            _, c_ = b_.prefill(sp, {"tokens": toks[:, :31]}, max_seq=32)
            got, _ = b_.decode_step(sp, c_, toks[:, 31:], 31)
            decode_rel[name] = rel_err(torch, got, want)
            check(decode_rel[name] < LM_REL,
                  f"smoke {name}: decode vs full forward rel "
                  f"{decode_rel[name]}")
    record("lm_smoke", arch=small.name, n_layers=small.n_layers,
           dynasparse_tokens_equal_dense=equal,
           tokens=[r.tokens.tolist() for r in r_ds],
           decode_vs_full_forward_rel=decode_rel, launches=small_counts)
    return counts


# phase 10: the LM layer kinds (MoE, MLA, mamba, xLSTM, encoder-decoder)
# at full width, each model freed before the next
def score_f32(torch, cfg, batch, dev, card) -> dict:
    """Phase 8b: one batch of ``cfg`` scored at full width in float32 with
    ``attn_impl="flash"`` (the float32 flash route, one launch a layer),
    its loss held within ``TOL`` relative to the same batch scored with
    ``attn_impl="chunked"`` in float32; wall, busy time and peak memory.
    Returns the window's launch counts."""
    import dataclasses

    import numpy as np

    import repro_torch.kernels as K
    from repro_torch.models import model_zoo, transformer

    t0 = time.perf_counter()
    flash = dataclasses.replace(cfg, dtype="float32", attn_impl="flash")
    chunked = dataclasses.replace(flash, attn_impl="chunked")
    params = model_zoo.build(flash, device=dev).init_params(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        K.reset_launch_counts()
        loss = float(transformer.loss_fn(flash, params, batch))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        want = float(transformer.loss_fn(chunked, params, batch))
        wall = wall_ms(torch, lambda: transformer.loss_fn(flash, params,
                                                          batch))
        prof = profile_device(torch, lambda: transformer.loss_fn(
            flash, params, batch), n=1, top=6)
    peak = torch.cuda.max_memory_allocated()
    rel = abs(loss - want) / abs(want)
    check(counts["flash_attention"] == cfg.n_layers,
          f"float32 scoring launched flash {counts['flash_attention']} "
          f"times, expected {cfg.n_layers}")
    check(np.isfinite(loss) and rel <= TOL,
          f"float32 flash loss {loss} vs chunked {want} (rel {rel})")
    record("lm_score_f32", arch=cfg.name, batch=SCORE_BATCH, seq=SCORE_SEQ,
           dtype="float32", loss_flash=loss, loss_chunked=want,
           rel_err=rel, tol=TOL, launches=counts, median_ms=wall,
           tokens_per_s=SCORE_BATCH * SCORE_SEQ / (wall / 1e3),
           profile=prof, peak_memory_bytes=peak,
           seconds=time.perf_counter() - t0, card=card)
    del params
    torch.cuda.empty_cache()
    return counts


DS_ARCH = "deepseek-v2-lite-16b"
DS_REQUESTS, DS_PROMPT, DS_NEW, DS_SLOTS = 4, 64, 8, 4
JAMBA_BATCH, JAMBA_PROMPT = 2, 256        # one period: n_layers 8
XLSTM_BATCH, XLSTM_PROMPT = 2, 512
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT = 2, 3000, 64
FAMILY_STEPS = 8                          # decode steps after each prefill


def dropless(cfg):
    """The MoE at capacity == group_size, the least capacity that drops no
    choice (a group holds group_size tokens, each picks an expert once)."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def decode_vs_forward(torch, bundle, params, toks, n_prefill, head,
                      around=None) -> list:
    """Prefill ``toks[:, :n_prefill]``, then decode the rest one token a
    step (teacher-forced); each step's logits against the full forward's
    at the same position (``head(x)`` -> logits).  Returns the relative
    errors, the prefill's first.  The context ``around`` is entered for
    the prefill and the decode steps, not for the full forward."""
    from repro_torch.models import transformer
    cfg = bundle.cfg
    with torch.inference_mode():
        x, _, _ = transformer.forward(cfg, params, toks)
        want = head(x[:, n_prefill - 1:])
        del x
        with around or contextlib.nullcontext():
            got, caches = bundle.prefill(
                params, {"tokens": toks[:, :n_prefill]},
                max_seq=toks.shape[1])
            rels = [rel_err(torch, got, want[:, 0])]
            for i in range(n_prefill, toks.shape[1]):
                got, caches = bundle.decode_step(params, caches,
                                                 toks[:, i:i + 1], i)
                rels.append(rel_err(torch, got, want[:, i - n_prefill + 1]))
    return rels


class ShapeCounter:
    """Observes every ``dynasparse_matmul`` call (the FFN's ``_linear``):
    its (x, w) shapes and the K2P codes it planned."""

    def __init__(self, torch, dynasparse):
        self.torch, self.mod = torch, dynasparse
        self.planned = dynasparse.dynasparse_matmul
        self.calls, self.hist = {}, [0, 0, 0, 0]

    def __enter__(self):
        def recording(x, w, *args, **kw):
            res = self.planned(x, w, *args, **kw)
            key = f"{tuple(x.shape)}x{tuple(w.shape)}"
            self.calls[key] = self.calls.get(key, 0) + 1
            h = self.torch.bincount(res.codes.flatten().long(), minlength=4)
            self.hist = [a + int(b) for a, b in zip(self.hist, h.tolist())]
            return res
        self.mod.dynasparse_matmul = recording
        return self

    def __exit__(self, *exc):
        self.mod.dynasparse_matmul = self.planned


class Routing:
    """Observes the top-k choices of every MoE call (``layers.moe_route``),
    in order: ``choices`` holds each call's (rows, k) experts.  Given
    ``expect`` (one (n, k) tensor a call), ``flips`` holds, per call, the
    tokens among the first n whose own choice set differs from the
    expected one, and with ``pin`` each call takes the expected choices
    instead of its own (the gate weights read off its own
    probabilities)."""

    def __init__(self, layers, expect=None, pin=False):
        self.mod, self.pin = layers, pin
        self.expect = None if expect is None else iter(expect)
        self.route = layers.moe_route
        self.choices, self.flips = [], []

    def __enter__(self):
        def routing(probs, k):
            w, i = self.route(probs, k)
            self.choices.append(i.reshape(-1, k))
            if self.expect is None:
                return w, i
            want = next(self.expect)
            n = want.shape[0]
            own = i.reshape(-1, k)
            self.flips.append(int((own[:n].sort(-1).values
                                   != want.sort(-1).values).any(-1).sum()))
            if not self.pin:
                return w, i
            idx = own.clone()
            idx[:n] = want
            idx = idx.reshape(i.shape)
            return probs.gather(-1, idx), idx
        self.mod.moe_route = routing
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.route


def routed_decode_vs_forward(torch, layers, bundle, params, toks, n_prefill,
                             head) -> dict:
    """``decode_vs_forward`` of an MoE model, the MoE choices of its
    prefill and of each decode step held against the full forward's at
    the same positions: run free (``rel``, and ``flips``: per step, the
    (token, MoE layer) choices that differ, the prefill's over its
    positions first) and with every choice pinned to the forward's
    (``pinned_rel``)."""
    from repro_torch.models import transformer
    b, s = toks.shape
    k = bundle.cfg.moe.top_k
    with torch.inference_mode(), Routing(layers) as fwd:
        transformer.forward(bundle.cfg, params, toks)
    per_pos = [c[:b * s].reshape(b, s, k) for c in fwd.choices]
    expect = [c[:, :n_prefill].reshape(-1, k) for c in per_pos]
    for p in range(n_prefill, s):
        expect += [c[:, p] for c in per_pos]
    out, n = {}, len(per_pos)
    for pin in (False, True):
        r = Routing(layers, expect, pin)
        rels = decode_vs_forward(torch, bundle, params, toks, n_prefill,
                                 head, around=r)
        out["pinned_rel" if pin else "rel"] = rels
        if not pin:
            out["flips"] = [sum(r.flips[i * n:(i + 1) * n])
                            for i in range(len(r.flips) // n)]
    return out


def lm_families_phase(torch, np, K, dev, card, kernel_entry) -> None:
    """Phase 10: deepseek-v2-lite-16b served at full width (MoE, MLA,
    dense-first layer), one period of jamba-v0.1-52b (mamba, attention,
    MoE), xlstm-125m and whisper-large-v3 at full width, then the smoke
    configs of all ten archs; each model's decode against its full
    forward, the Dynasparse FFN's kernels launched on each path."""
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS, get_arch, smoke_config
    from repro_torch.core import analyzer, dynasparse, profiler
    from repro_torch.core.perf_model import TPUCostModel
    from repro_torch.launch.serve import leaf_groups, prune_ffn, _get
    from repro_torch.models import encdec, layers, model_zoo, transformer
    from repro_torch.serving.engine import Request, ServeEngine

    replace = dataclasses.replace
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def make(cfg, seed, prune=True):
        """Random params of ``cfg`` on the card, FFN leaves pruned (in
        place) to SERVE_DENSITY; their density after the prune."""
        params = model_zoo.build(cfg, device=dev).init_params(seed)
        density = None
        if prune:
            prune_ffn(params, SERVE_DENSITY, period=cfg.layer_period)
            ws = [_get(params[k][j], path)
                  for g in leaf_groups(params, cfg.layer_period)
                  for k, j, path in g]
            density = float(sum(int(torch.count_nonzero(w)) for w in ws)
                            / sum(w.numel() for w in ws))
        torch.cuda.synchronize()
        return params, density

    def tokens_of(rng, vocab, b, s):
        return torch.from_numpy(rng.integers(0, vocab, (b, s))).to(dev)

    # ---------------- (a) deepseek-v2-lite-16b, full width, served --------
    t0 = fresh()
    cfg = get_arch(DS_ARCH)
    params, density = make(cfg, 0)
    record("family_bundle", arch=cfg.name, n_layers=cfg.n_layers,
           d_model=cfg.d_model, n_heads=cfg.n_heads, dtype=cfg.dtype,
           experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
           shared=cfg.moe.n_shared, kv_lora_rank=cfg.mla.kv_lora_rank,
           params=sum(t.numel() for t in leaves(params)),
           ffn_density_after_prune=density,
           param_bytes=torch.cuda.memory_allocated(),
           seconds=time.perf_counter() - t0)
    dense_b = model_zoo.build(cfg, device=dev)
    ds_b = model_zoo.build(replace(cfg, dynasparse_ffn=True), device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, DS_PROMPT).astype(np.int32)
               for _ in range(DS_REQUESTS)]
    wave = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)

    # dispatch at deepseek's decode shapes: the dense-first FFN (ragged N
    # 10944 = 42.75 blocks of 256) and the shared experts (2 x 1408)
    blk = layers.FFN_BLOCK
    df = params["dense_first"][0]
    sh = params["layers"][0]["ffn"]["shared"]
    x = layers.rmsnorm(params["embed"][wave[:, -1]], df["ln2"]["scale"])
    hid = F.silu(x @ df["ffn"]["w1"]) * (x @ df["ffn"]["w3"])
    hid_s = F.silu(x @ sh["w1"]) * (x @ sh["w3"])
    for label, xs, w in (("dense-first w1", x, df["ffn"]["w1"]),
                         ("dense-first w2", hid, df["ffn"]["w2"]),
                         ("shared experts w1", x, sh["w1"]),
                         ("shared experts w2", hid_s, sh["w2"])):
        codes = analyzer.plan_codes(
            "dynamic", profiler.block_density(xs, blk[:2]),
            profiler.block_density(w, blk[1:]), TPUCostModel())
        kernel_entry(
            f"dispatch (bf16, 256, decode {xs.shape[0]} rows, deepseek "
            f"{label} {tuple(w.shape)})",
            "src/repro_torch/kernels/csrc/dispatch.cu",
            "src/repro/core/dynasparse.py:239",
            lambda xs=xs, w=w, codes=codes:
            K.dispatch.block_matmul(xs, w, codes, blk, pad_rows=False),
            lambda xs=xs, w=w, codes=codes:
            K.dispatch.block_matmul_plain(xs, w, codes, blk, pad_rows=False),
            lambda xs=xs, w=w: torch.matmul(xs, w),
            dispatch_work(torch, K, xs, w, codes, blk), lambda g, w: True,
            tol=DISPATCH_BF16_TOL, peak=PEAK_BF16, line=False, units="mma",
            lib_call="torch.matmul")
        record("dispatch_codes", case=f"deepseek decode {label}",
               rows=xs.shape[0], shape=list(w.shape),
               histogram=torch.bincount(codes.flatten().long(),
                                        minlength=4).tolist())
    del x, hid, hid_s

    reqs = [Request(p, max_new_tokens=DS_NEW, request_id=i)
            for i, p in enumerate(prompts)]
    engines = {name: ServeEngine(b_, params, slots=DS_SLOTS,
                                 max_seq=DS_PROMPT + DS_NEW)
               for name, b_ in (("dynasparse", ds_b), ("dense", dense_b))}
    # each engine's first run is its warm-up, untimed; the dynasparse one
    # is observed too (the shapes and K2P codes of its linear calls)
    with ShapeCounter(torch, dynasparse) as seen:
        K.reset_launch_counts()
        res_ds = engines["dynasparse"].generate(reqs)
        torch.cuda.synchronize()
        serve_counts = K.launch_counts()
    serve_hist = seen.hist
    record("family_serve_launches", arch=cfg.name, counts=serve_counts,
           linear_calls=seen.calls)
    for name in ("dispatch", "tile_nnz"):
        check(serve_counts[name] > 0, f"{cfg.name} serving never launched "
              f"{name}")
    check(sum(serve_hist) > 0 and serve_hist[1] < sum(serve_hist),
          f"{cfg.name} dynasparse K2P histogram {serve_hist} is all GEMM")
    res_dense = engines["dense"].generate(reqs)
    walls = {}
    for _ in range(3):
        for name in ("dynasparse", "dense"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engines[name].generate(reqs)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t)
    agree_tok = float(np.mean([np.mean(a.tokens == b_.tokens)
                               for a, b_ in zip(res_ds, res_dense)]))
    with torch.inference_mode():
        first = {name: b_.prefill(params, {"tokens": wave},
                                  max_seq=DS_PROMPT + DS_NEW)
                 for name, b_ in (("dynasparse", ds_b), ("dense", dense_b))}
        first_rel = rel_err(torch, first["dynasparse"][0],
                            first["dense"][0])
        caches = first["dynasparse"][1]
        del first
        step = torch.from_numpy(np.array([[int(r.tokens[0])] for r in
                                          res_ds])).to(dev)
        launches = {}
        for what, fn in (
                ("prefill", lambda: ds_b.prefill(
                    params, {"tokens": wave}, max_seq=DS_PROMPT + DS_NEW)),
                ("decode_step", lambda: ds_b.decode_step(
                    params, caches, step, DS_PROMPT))):
            with ShapeCounter(torch, dynasparse) as seen:
                K.reset_launch_counts()
                fn()
                torch.cuda.synchronize()
                launches[what] = {"kernels": K.launch_counts(),
                                  "linear_calls": seen.calls}
        prof = profile_device(torch, lambda: ds_b.decode_step(
            params, caches, step, DS_PROMPT))
        dense_prof = profile_device(torch, lambda: dense_b.decode_step(
            params, caches, step, DS_PROMPT))
        del caches
    check(first_rel < LM_REL,
          f"{cfg.name} first-step logits dynasparse vs dense rel {first_rel}")
    n_tok = DS_REQUESTS * DS_NEW
    for name, ts in walls.items():
        ms = statistics.median(ts) * 1e3
        record("wall", path="lm_family_serve", arch=cfg.name, engine=name,
               median_ms=ms, runs_ms=[t_ * 1e3 for t_ in ts], tokens=n_tok,
               tokens_per_s=n_tok / (ms / 1e3), card=card)
    record("profile", path="lm_family_serve", arch=cfg.name,
           engine="dynasparse", what=f"one decode step ({DS_SLOTS} slots)",
           card=card, **prof)
    record("profile", path="lm_family_serve", arch=cfg.name, engine="dense",
           what=f"one decode step ({DS_SLOTS} slots)", card=card,
           **dense_prof)

    # decode against the full forward, dropless; and every MLA layer's
    # absorbed decode against its non-absorbed decode, on the same input
    # and a copy of the same latent cache
    dl = dropless(cfg)
    dl_b = model_zoo.build(dl, device=dev)
    head = lambda h: h @ transformer.lm_head(dl, params).T  # noqa: E731
    n_pre = DS_PROMPT - FAMILY_STEPS
    mla = transformer.mla_attention
    abs_rels = []

    def both_forms(x, p, cfg_, *, positions, cache, pos, absorbed):
        if cache is None or x.shape[1] != 1:
            return mla(x, p, cfg_, positions=positions, cache=cache,
                       pos=pos, absorbed=absorbed)
        copy = {k: v.clone() for k, v in cache.items()}
        alt, _ = mla(x, p, cfg_, positions=positions, cache=copy, pos=pos,
                     absorbed=not absorbed)
        out, cache = mla(x, p, cfg_, positions=positions, cache=cache,
                         pos=pos, absorbed=absorbed)
        abs_rels.append(rel_err(torch, alt, out))
        return out, cache

    transformer.mla_attention = both_forms
    try:
        fwd_rels = decode_vs_forward(torch, dl_b, params, wave, n_pre, head)
    finally:
        transformer.mla_attention = mla
    check(len(abs_rels) == FAMILY_STEPS * cfg.n_layers,
          f"{len(abs_rels)} MLA decode comparisons")
    check(max(fwd_rels) < LM_REL, f"{cfg.name} decode vs full forward rel "
          f"{fwd_rels}")
    check(max(abs_rels) < LM_REL, f"{cfg.name} MLA absorbed vs non-absorbed "
          f"decode rel {max(abs_rels)}")
    record("lm_family", arch=cfg.name, requests=DS_REQUESTS,
           prompt=DS_PROMPT, new_tokens=DS_NEW, slots=DS_SLOTS,
           ffn_density=SERVE_DENSITY,
           k2p_histogram_skip_gemm_spdmm_spmm=serve_hist,
           first_step_logits_rel_err=first_rel,
           token_agreement_dynasparse_vs_dense=agree_tok,
           launches_per_prefill=launches["prefill"],
           launches_per_decode_step=launches["decode_step"],
           decode_vs_forward_rel=fwd_rels, dropless_capacity_factor=(
               dl.moe.capacity_factor),
           mla_absorbed_vs_plain_decode_rel_max=max(abs_rels),
           mla_absorbed_vs_plain_decode_rel_median=statistics.median(
               abs_rels),
           peak_memory_bytes=torch.cuda.max_memory_allocated(),
           seconds=time.perf_counter() - t0, card=card)
    del params, engines, dense_b, ds_b, dl_b, res_ds, res_dense

    # ---------------- (b) jamba-v0.1-52b, one period at full width --------
    # float32 (53 GB, unpruned) holds decode to the full forward; bf16 (the
    # config's, 26 GB, FFNs pruned) is served dynasparse against dense and
    # decoded with its MoE choices held against the full forward's
    t0 = fresh()
    cfg = dropless(replace(get_arch("jamba-v0.1-52b"), n_layers=8,
                           dtype="float32"))
    params, _ = make(cfg, 1, prune=False)
    b_ = model_zoo.build(cfg, device=dev)
    rng = np.random.default_rng(6)
    toks = tokens_of(rng, cfg.vocab_size, JAMBA_BATCH,
                     JAMBA_PROMPT + FAMILY_STEPS)
    head = lambda h: h @ transformer.lm_head(cfg, params).T  # noqa: E731
    rels = decode_vs_forward(torch, b_, params, toks, JAMBA_PROMPT, head)
    check(max(rels) < LM_REL, f"{cfg.name} float32 decode vs full forward "
          f"{rels}")
    f32 = {"decode_vs_forward_rel": rels,
           "params": sum(t.numel() for t in leaves(params)),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t0}
    del params, b_

    t1 = fresh()
    cfg = replace(cfg, dtype=get_arch("jamba-v0.1-52b").dtype)
    params, density = make(cfg, 1)
    b_ = model_zoo.build(cfg, device=dev)
    ds = model_zoo.build(replace(cfg, dynasparse_ffn=True), device=dev)
    head = lambda h: h @ transformer.lm_head(cfg, params).T  # noqa: E731
    routed = routed_decode_vs_forward(torch, layers, b_, params, toks,
                                      JAMBA_PROMPT, head)
    check(max(routed["pinned_rel"]) < LM_REL, f"{cfg.name} bf16 decode vs "
          f"full forward, MoE choices pinned to the forward's: {routed}")
    prompt = {"tokens": toks[:, :JAMBA_PROMPT]}
    routes = {"mma": K.dispatch._block_matmul_mma,
              "fma": K.dispatch._block_matmul_fma}
    route_calls = {"mma": 0, "fma": 0}

    def counted(name):
        def call(*a):
            route_calls[name] += 1
            return routes[name](*a)
        return call
    with torch.inference_mode():
        with Routing(layers) as dense_route:
            want, _ = b_.prefill(params, prompt)
        with Routing(layers, dense_route.choices) as free:
            got_free, _ = ds.prefill(params, prompt)
        K.dispatch._block_matmul_mma = counted("mma")
        K.dispatch._block_matmul_fma = counted("fma")
        try:
            with ShapeCounter(torch, dynasparse) as seen, \
                    Routing(layers, dense_route.choices, pin=True):
                K.reset_launch_counts()
                got, _ = ds.prefill(params, prompt)
                torch.cuda.synchronize()
                counts = K.launch_counts()
        finally:
            K.dispatch._block_matmul_mma = routes["mma"]
            K.dispatch._block_matmul_fma = routes["fma"]
        ms = {name: wall_ms(torch, lambda m=m: m.prefill(params, prompt),
                            n=2)
              for name, m in (("dense", b_), ("dynasparse", ds))}
    ds_rel = rel_err(torch, got, want)
    for name in ("dispatch", "tile_nnz"):
        check(counts[name] > 0, f"{cfg.name} dense FFNs never launched "
              f"{name} under dynasparse_ffn")
    check(route_calls["mma"] > 0 and route_calls["fma"] == 0,
          f"{cfg.name} bf16 dispatch routes {route_calls}, not all mma")
    check(ds_rel < LM_REL, f"{cfg.name} dynasparse vs dense prefill, MoE "
          f"choices pinned to dense's: {ds_rel}")
    record("lm_family", arch=cfg.name, n_layers=cfg.n_layers,
           kinds=[f"{k['mixer']}/{k['ffn']}"
                  for k in transformer.layer_kinds(cfg)],
           reduced="n_layers 32 -> 8 (one period)", dtype=cfg.dtype,
           params=sum(t.numel() for t in leaves(params)),
           ffn_density_after_prune=density, batch=JAMBA_BATCH,
           prompt=JAMBA_PROMPT, steps=FAMILY_STEPS, float32=f32,
           decode_vs_forward_rel=routed["rel"],
           decode_vs_forward_moe_flips=routed["flips"],
           decode_vs_forward_rel_pinned=routed["pinned_rel"],
           dynasparse_vs_dense_prefill_rel=ds_rel,
           dynasparse_vs_dense_prefill_rel_free=rel_err(torch, got_free,
                                                        want),
           dynasparse_vs_dense_prefill_moe_flips_free=sum(free.flips),
           dynasparse_prefill_launches=counts, dispatch_route_calls=route_calls,
           linear_calls=seen.calls,
           k2p_histogram_skip_gemm_spdmm_spmm=seen.hist,
           prefill_ms=ms, peak_memory_bytes=torch.cuda.max_memory_allocated(),
           seconds=time.perf_counter() - t1, card=card)
    del params, b_, ds, got, got_free, want

    # ---------------- (c) xlstm-125m, full width, float32 ----------------
    t0 = fresh()
    cfg = replace(get_arch("xlstm-125m"), dtype="float32")
    params, _ = make(cfg, 2, prune=False)
    b_ = model_zoo.build(cfg, device=dev)
    toks = tokens_of(np.random.default_rng(7), cfg.vocab_size, XLSTM_BATCH,
                     XLSTM_PROMPT + FAMILY_STEPS)
    head = lambda h: h @ transformer.lm_head(cfg, params).T  # noqa: E731
    rels = decode_vs_forward(torch, b_, params, toks, XLSTM_PROMPT, head)
    check(max(rels) < LM_REL, f"{cfg.name} decode vs full forward {rels}")
    with torch.inference_mode():
        _, c = b_.prefill(params, {"tokens": toks[:, :XLSTM_PROMPT]},
                          max_seq=XLSTM_PROMPT + 1)
        ms = {"prefill": wall_ms(torch, lambda: b_.prefill(
            params, {"tokens": toks[:, :XLSTM_PROMPT]}), n=2),
            "decode_step": wall_ms(torch, lambda: b_.decode_step(
                params, c, toks[:, XLSTM_PROMPT:XLSTM_PROMPT + 1],
                XLSTM_PROMPT), n=3)}
    record("lm_family", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
           kinds=[k["mixer"] for k in transformer.layer_kinds(cfg)],
           params=sum(t.numel() for t in leaves(params)),
           batch=XLSTM_BATCH, prompt=XLSTM_PROMPT, steps=FAMILY_STEPS,
           decode_vs_forward_rel=rels, ms=ms,
           peak_memory_bytes=torch.cuda.max_memory_allocated(),
           seconds=time.perf_counter() - t0, card=card)
    del params, b_, c

    # ---------------- (d) whisper-large-v3, full width -------------------
    t0 = fresh()
    cfg = get_arch("whisper-large-v3")
    params, density = make(cfg, 3)
    b_ = model_zoo.build(cfg, device=dev)
    gen.manual_seed(8)
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=gen, device=dev, dtype=cfg.jdtype)
    prompt = tokens_of(np.random.default_rng(9), cfg.vocab_size,
                       WHISPER_BATCH, WHISPER_PROMPT)
    max_seq = WHISPER_PROMPT + FAMILY_STEPS
    batch = {"frames": frames, "tokens": prompt}
    with torch.inference_mode():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = b_.prefill(params, batch, max_seq=max_seq)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        outs, toks = [logits], [prompt]
        t = time.perf_counter()
        for i in range(FAMILY_STEPS):
            nxt = outs[-1][:, :cfg.vocab_size].argmax(-1)[:, None]
            toks.append(nxt)
            logits, caches = b_.decode_step(params, caches, nxt,
                                            WHISPER_PROMPT + i)
            outs.append(logits)
        torch.cuda.synchronize()
        decode_s = (time.perf_counter() - t) / FAMILY_STEPS
        del caches
        seq = torch.cat(toks, 1)
        enc = encdec.encode(cfg, params, frames)
        x, _ = encdec.decoder_forward(cfg, params, seq, enc)
        del enc
        want = x[:, WHISPER_PROMPT - 1:] @ params["embed"].T
        rels = [rel_err(torch, o, want[:, i]) for i, o in enumerate(outs)]
        ds = model_zoo.build(replace(cfg, dynasparse_ffn=True), device=dev)
        with ShapeCounter(torch, dynasparse) as seen:
            K.reset_launch_counts()
            got, c2 = ds.prefill(params, batch, max_seq=max_seq)
            torch.cuda.synchronize()
            counts = K.launch_counts()
        del c2
        ds_rel = rel_err(torch, got, outs[0])
    check(max(rels) < LM_REL, f"{cfg.name} decode vs decoder_forward {rels}")
    for name in ("dispatch", "tile_nnz"):
        check(counts[name] > 0, f"{cfg.name} never launched {name} under "
              "dynasparse_ffn")
    check(ds_rel < LM_REL, f"{cfg.name} dynasparse vs dense prefill {ds_rel}")
    record("lm_family", arch=cfg.name, enc_layers=cfg.encdec.n_enc_layers,
           dec_layers=cfg.n_layers, params=sum(
               t.numel() for t in leaves(params)),
           ffn_density_after_prune=density, batch=WHISPER_BATCH,
           frames=WHISPER_FRAMES, prompt=WHISPER_PROMPT, steps=FAMILY_STEPS,
           greedy_tokens=seq[:, WHISPER_PROMPT:].tolist(),
           decode_vs_forward_rel=rels, dynasparse_vs_dense_prefill_rel=ds_rel,
           dynasparse_prefill_launches=counts, linear_calls=seen.calls,
           k2p_histogram_skip_gemm_spdmm_spmm=seen.hist,
           prefill_s=prefill_s, decode_step_s=decode_s,
           peak_memory_bytes=torch.cuda.max_memory_allocated(),
           seconds=time.perf_counter() - t0, card=card)
    del params, b_, ds, frames, x, want, outs, got

    # ---------------- (e) the smoke configs of all ten archs -------------
    t0 = fresh()
    smoke = {}
    for arch in sorted(ARCHS):
        cfg = smoke_config(arch)
        if cfg.moe is not None:     # the reference test's dropless MoE
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=float(
                cfg.moe.n_experts * cfg.moe.top_k)))
        if cfg.xlstm is not None:   # and its float32 xLSTM
            cfg = replace(cfg, dtype="float32")
        b_ = model_zoo.build(cfg, device=dev)
        params = b_.init_params(4)
        toks = tokens_of(np.random.default_rng(10), cfg.vocab_size, 2, 32)
        if cfg.encdec is None:
            head = lambda h, c=cfg, p=params: \
                h @ transformer.lm_head(c, p).T  # noqa: E731
            smoke[arch] = max(decode_vs_forward(torch, b_, params, toks, 31,
                                                head))
        else:
            gen.manual_seed(11)
            fr = torch.randn((2, 32, cfg.d_model), generator=gen,
                             device=dev, dtype=cfg.jdtype)
            with torch.inference_mode():
                enc = encdec.encode(cfg, params, fr)
                x, _ = encdec.decoder_forward(cfg, params, toks[:, :8], enc)
                want = x[:, -1] @ params["embed"].T
                _, c = b_.prefill(params, {"frames": fr,
                                           "tokens": toks[:, :7]}, max_seq=8)
                got, _ = b_.decode_step(params, c, toks[:, 7:8], 7)
            smoke[arch] = rel_err(torch, got, want)
        check(smoke[arch] < LM_REL, f"smoke {arch}: decode vs full forward "
              f"rel {smoke[arch]}")
    record("lm_family_smoke", decode_vs_forward_rel=smoke,
           seconds=time.perf_counter() - t0)
    record("phase", name="10 LM families",
           seconds=time.perf_counter() - t_phase, card=card)


# phase 11: LM training, llama3.2-1b at full width on the one card, with
# the CLI's defaults (launch/train.py): batch 8 x 256 tokens, lr 3e-3,
# warmup 20, float32 optimizer state
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 256, 4, 3e-3
TRAIN_REL = 5e-2        # dynasparse vs dense first-step loss and grad norm
RESTART_TOL = 1e-5      # restarted vs uninterrupted final params
# deepseek-v2-lite-16b's dense-first FFN width (configs/deepseek_v2_lite
# _16b.py d_ff_dense): a ragged 42.75 blocks of 256
RAGGED_FF = 10944


def train_phase(torch, np, K, dev, card, kernel_entry) -> dict:
    """Phase 11: (a) the dispatch backward at llama3.2-1b's FFN shapes
    (2048 tokens; w1 2048 -> 8192, w2 8192 -> 2048) in bf16 and float32
    against autograd through ``block_matmul_plain``, zero 256-blocks
    planted in x and w, each backward product checked against its plain
    version and timed (``dispatch_bwd``, both types, also on a grid with
    half of w1's blocks SKIPped and at a ragged width; float32 also as
    the two ``dispatch`` launches it replaced), and each forward product
    (bf16 on the walk, float32 on ``block_matmul_nn`` beside the walk it
    replaced, also on the half-SKIPped grid and the ragged width); (b)
    four training steps
    at full width with ``dynasparse_ffn`` (``make_train_step`` +
    ``Trainer`` + ``TokenPipeline``), launches per step counted, and the
    same four steps dense; (c) ``launch.train.main`` with a failure at
    step 2 and a restart from the step-2 checkpoint, held to the dense
    run; (d) one warm and one profiled float32 dynasparse step, held to
    the same first step with the forward on the walk (bitwise) and to a
    dense float32 step.  Returns the launch counts of (b)'s and (d)'s
    windows."""
    import contextlib
    import io
    import shutil

    from repro_torch.configs import get_arch
    from repro_torch.core import analyzer, dynasparse, profiler
    from repro_torch.core.perf_model import TPUCostModel
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models import layers, model_zoo
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import Trainer, TrainState, \
        make_train_step

    t_phase = time.perf_counter()
    blk = layers.FFN_BLOCK
    bm, bk, bn = blk
    cfg = get_arch(LM_ARCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)

    # ---- (a) the backward against autograd of the plain version --------
    def operand(rows, cols, scale):
        t = torch.randn((rows, cols), generator=gen, device=dev) * scale
        t[:bm, bk:2 * bk] = 0          # one zero 256-block: SKIP codes
        return t

    def planned(xs, ws):
        return analyzer.plan_codes(
            "dynamic", profiler.block_density(xs, blk[:2]),
            profiler.block_density(ws, blk[1:]), TPUCostModel())

    def skipped_rows(codes, m, k):
        """x's elements in a block that every step SKIPped: dx is 0."""
        skipped = ((codes != 0).sum(1) == 0)                 # (I, Kb)
        return skipped.repeat_interleave(bm, 0).repeat_interleave(
            bk, 1)[:m, :k], skipped

    def two_launch(layout, a, b, codes):
        """The float32 route before ``dispatch_bwd_f32``: two ``dispatch``
        launches over a transposed operand and the permuted GEMM/SKIP
        grid, as ``BlockMatmulFn`` still runs them at edges below 64."""
        run = (codes != 0).to(torch.int32)
        if layout == "nt":
            return K.dispatch.block_matmul(
                a, b.T, run.permute(0, 2, 1).contiguous(), (bm, bn, bk),
                pad_rows=False)[:a.shape[0], :b.shape[0]]
        return K.dispatch.block_matmul(
            a.T, b, run.permute(2, 1, 0).contiguous(), (bk, bm, bn),
            pad_rows=False)[:a.shape[1], :b.shape[1]]

    x = operand(tokens, cfg.d_model, 1.0)
    w1 = operand(cfg.d_model, cfg.d_ff, cfg.d_model ** -0.5)
    h = operand(tokens, cfg.d_ff, 1.0)
    w2 = operand(cfg.d_ff, cfg.d_model, cfg.d_ff ** -0.5)
    backward_cases = {}
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        bf16 = dtype == torch.bfloat16
        for prod, (xs, ws) in (("w1", (x, w1)), ("w2", (h, w2))):
            xs, ws = xs.to(dtype), ws.to(dtype)
            codes = planned(xs, ws)
            m, n = xs.shape[0], ws.shape[1]
            g = torch.randn((m, n), generator=gen, device=dev).to(
                dtype).float()
            grads = {}
            for route in ("kernel", "plain"):
                xr = xs.clone().requires_grad_()
                wr = ws.clone().requires_grad_()
                K.reset_launch_counts()
                if route == "kernel":
                    out = dynasparse.BlockMatmulFn.apply(xr, wr, codes, blk)
                else:
                    out = K.dispatch.block_matmul_plain(
                        xr, wr, codes, blk, pad_rows=False)[:m, :n]
                out.backward(g)
                torch.cuda.synchronize()
                c = K.launch_counts()
                launched = (c["dispatch"], c["dispatch_bwd"])
                want = ((0, 0) if route == "plain" else (1, 2)
                        if K.dispatch_bwd.takes(dtype, blk) else (3, 0))
                check(launched == want,
                      f"backward {label} {prod}: {launched} dispatch, "
                      f"dispatch_bwd launches by the {route} route "
                      f"(want {want})")
                grads[route] = (xr.grad, wr.grad)
                del out, xr, wr
            copies = {}
            if not bf16:    # the copy kernels of a float32 forward and
                # backward (none: g, w, x and the codes read in place),
                # beside the two-launch route's products
                xr = xs.clone().requires_grad_()
                wr = ws.clone().requires_grad_()
                copies = {route: profile_device(
                    torch, fn, n=1, top=8, warm=False, windows=1)
                    for route, fn in (
                        ("kernel", lambda: dynasparse.BlockMatmulFn.apply(
                            xr, wr, codes, blk).backward(g)),
                        ("two_launch", lambda: (
                            two_launch("nt", g, ws, codes),
                            two_launch("tn", xs, g, codes))))}
                copies = {route: {k: p_.get(k) for k in (
                    "complete", "copy_launches", "copy_ms",
                    "top_device_ops")} for route, p_ in copies.items()}
                check(not copies["kernel"]["complete"]
                      or copies["kernel"]["copy_launches"] == 0,
                      f"float32 backward {prod}: copy kernels "
                      f"{copies['kernel']}")
                del xr, wr
            mask, skipped = skipped_rows(codes, m, xs.shape[1])
            check(bool(skipped[0, 1]), f"{prod}: the planted zero block "
                  "of x was not SKIPped by every step")
            dense = (g @ ws.float().T)
            check(bool(torch.all(grads["kernel"][0][mask] == 0)),
                  f"{prod} {label}: dx not 0 where every step SKIPped")
            errs = {}
            for i, name in ((0, "dx"), (1, "dw")):
                got = grads["kernel"][i].float()
                want = grads["plain"][i].float()
                errs[name] = float((got - want).abs().max()
                                   / want.abs().max())
                errs[name + "_bitwise"] = bool(torch.equal(got, want))
                check(errs[name] <= (BF16_TOL if bf16 else TOL),
                      f"backward {label} {prod} {name}: rel err "
                      f"{errs[name]}")
            record("train_backward_check", dtype=label, product=prod,
                   x=list(xs.shape), w=list(ws.shape),
                   codes_histogram=torch.bincount(
                       codes.flatten().long(), minlength=4).tolist(),
                   skipped_x_blocks=int(skipped.sum()),
                   dense_dx_in_skipped=float(dense[mask].abs().max()),
                   rel_err_vs_autograd_of_plain=errs,
                   tol=BF16_TOL if bf16 else TOL, copy_kernels=copies)
            backward_cases[(label, prod)] = (xs, ws, g.to(dtype), codes)
            del grads, dense, mask

    def rel_to_max(got, want, tol):
        """(max|err|, ok): within ``tol`` of the largest |want| -- dw sums
        2048 token products of size ~1 (|dw| ~ 45), so float32 order
        differences reach 7e-4 absolute where an elementwise tolerance
        reads them against small entries; a stale 64-deep stage would
        move a sum by ~10 % of its size."""
        err = float((got.double() - want.double()).abs().max())
        return err, err <= tol * float(want.double().abs().max())

    B = K.dispatch_bwd
    products = {"nt": (B.block_matmul_nt, B.block_matmul_nt_plain,
                       lambda a, b: torch.matmul(a, b.T)),
                "tn": (B.block_matmul_tn, B.block_matmul_tn_plain,
                       lambda a, b: torch.matmul(a.T, b))}

    def bwd_entry(case, layout, a, b, codes, line=False, zero=None):
        """Check and time one ``dispatch_bwd`` product.  bf16: its float32
        sums within ``DISPATCH_BF16_TOL`` of the plain version's, its bf16
        result (the one the training path takes and the one timed) their
        rounding, bitwise.  float32: within ``TOL`` of the largest |want|
        of the plain version, and whether it equals the two-launch route
        bitwise (recorded).  Both 0 on ``zero``."""
        fn, plain, lib = products[layout]
        f32 = a.dtype == torch.float32

        def compare(got, want, tol):
            zeros = zero is None or bool(torch.all(got[zero] == 0))
            if f32:
                err, ok = rel_to_max(got, want, tol)
                old = two_launch(layout, a, b, codes)
                record("dispatch_bwd_check", case=case, layout=layout,
                       dtype="float32", max_abs_err=err,
                       max_abs_want=float(want.abs().max()), tol=tol,
                       zero_where_skipped=zeros,
                       bitwise_two_launch=bool(torch.equal(got, old)),
                       bitwise_plain=bool(torch.equal(got, want)))
                del old
                return err, ok and zeros
            k32 = fn(a, b, codes, blk, out_dtype=torch.float32)
            p32 = plain(a, b, codes, blk, out_dtype=torch.float32)
            err, ok = rel_to_max(k32, p32, tol)
            rounded = torch.equal(got, k32.to(got.dtype))
            record("dispatch_bwd_check", case=case, layout=layout,
                   max_abs_err_f32=err,
                   max_abs_want=float(p32.abs().max()), tol=tol,
                   bf16_is_f32_rounded=rounded, zero_where_skipped=zeros,
                   bf16_max_abs_diff_vs_plain=float(
                       (got.float() - want.float()).abs().max()))
            del k32, p32
            return err, ok and rounded and zeros

        return kernel_entry(
            case, "src/repro_torch/kernels/csrc/" + (
                "dispatch_bwd_f32.cu" if f32 else "dispatch_bwd.cu"),
            "src/repro/core/dynasparse.py:239",
            lambda: fn(a, b, codes, blk), lambda: plain(a, b, codes, blk),
            lambda: lib(a, b), tiled_work(torch, layout, a, b, codes, blk),
            lambda g_, w_: True, tol=TOL if f32 else DISPATCH_BF16_TOL,
            peak=PEAK_FP32 if f32 else PEAK_BF16,
            units="fma" if f32 else "wgmma", line=line,
            line_name=BWD_F32 if f32 else "dispatch_bwd", compare=compare,
            lib_call="torch.matmul (the operand transposed, a view)")

    D = K.dispatch

    def walk(xs, ws, codes):
        """The forward on the walk (``dispatch.block_matmul``), cut to (m,
        n): how BlockMatmulFn runs bf16, and ran float32 before
        ``block_matmul_nn``."""
        return D.block_matmul(xs, ws, codes, blk,
                              pad_rows=False)[:xs.shape[0], :ws.shape[1]]

    def fwd_entry(case, xs, ws, codes, line=False):
        """Check and time one forward product as ``BlockMatmulFn`` runs
        it.  bf16: the walk's mma route within ``DISPATCH_BF16_TOL`` of
        the plain version.  float32: ``block_matmul_nn`` (the tiled kernel's
        nn layout) bitwise the walk and within ``TOL`` of the largest
        |want| of the plain version; the walk timed beside it."""
        m, n = xs.shape[0], ws.shape[1]
        plain = lambda: D.block_matmul_plain(  # noqa: E731
            xs, ws, codes, blk, pad_rows=False)[:m, :n]
        lib = lambda: torch.matmul(xs, ws)  # noqa: E731
        if xs.dtype == torch.bfloat16:
            return kernel_entry(
                case, "src/repro_torch/kernels/csrc/dispatch.cu",
                "src/repro/core/dynasparse.py:239",
                lambda: walk(xs, ws, codes), plain, lib,
                dispatch_work(torch, K, xs, ws, codes, blk),
                lambda g_, w_: True, tol=DISPATCH_BF16_TOL, peak=PEAK_BF16,
                line=False, units="mma", lib_call="torch.matmul")

        def compare(got, want, tol):
            err, ok = rel_to_max(got, want, tol)
            same = bool(torch.equal(got, walk(xs, ws, codes)))
            record("dispatch_nn_check", case=case, max_abs_err=err,
                   max_abs_want=float(want.abs().max()), tol=tol,
                   bitwise_walk=same,
                   bitwise_plain=bool(torch.equal(got, want)))
            return err, ok and same

        entry = kernel_entry(
            case, "src/repro_torch/kernels/csrc/dispatch_bwd_f32.cu",
            "src/repro/core/dynasparse.py:239",
            lambda: D.block_matmul_nn(xs, ws, codes, blk), plain, lib,
            tiled_work(torch, "nn", xs, ws, codes, blk),
            lambda g_, w_: True, tol=TOL, peak=PEAK_FP32, units="fma",
            line=line, line_name=FWD_F32, compare=compare,
            lib_call="torch.matmul")
        b_ms, b_by = bound(*dispatch_work(torch, K, xs, ws, codes, blk))
        walk_ms = cuda_ms(torch, lambda: walk(xs, ws, codes))
        record("kernel", name=f"{case}, on the walk", route="fma",
               source="src/repro_torch/kernels/csrc/dispatch.cu",
               max_abs_err=entry["max_abs_err"], bitwise_tiled=True,
               ms=walk_ms, plain_ms=entry["plain_ms"],
               library_ms=entry["library_ms"], bound_ms=b_ms,
               bound_by=b_by, tol=TOL, tiled_ms=entry["ms"],
               walk_over_tiled=walk_ms / entry["ms"],
               in_kernels_line=False)
        return entry

    # each forward and backward product as the Function makes it, timed
    for (label, prod), (xs, ws, gd, codes) in backward_cases.items():
        tag = "" if label == "bf16" else "float32, "
        route = "bf16" if label == "bf16" else "float32, tiled"
        fwd_entry(f"dispatch ({route} forward of {prod}: {tuple(xs.shape)} "
                  f"@ {tuple(ws.shape)})", xs, ws, codes,
                  line=(label, prod) == ("f32", "w1"))
        mask = skipped_rows(codes, *xs.shape)[0]
        bwd_entry(f"dispatch_bwd ({tag}dx of {prod}: {tuple(gd.shape)} @ "
                  f"{tuple(ws.shape)}.T)", "nt", gd, ws, codes,
                  line=prod == "w1", zero=mask)
        bwd_entry(f"dispatch_bwd ({tag}dw of {prod}: {tuple(xs.shape)}.T @ "
                  f"{tuple(gd.shape)})", "tn", xs, gd, codes)
        if label == "bf16":
            continue
        # float32 beside it: the two dispatch launches (fma route) over the
        # permuted grids that served it before dispatch_bwd_f32 (and still
        # serve float32 at edges below 64), checked and timed by CUDA
        # events only (the float32 dispatch equals its plain version
        # bitwise)
        run = (codes != 0).to(torch.int32)
        for name, a, b, c, b_ in (
                ("dx", gd, ws.T, run.permute(0, 2, 1).contiguous(),
                 (bm, bn, bk)),
                ("dw", xs.T, gd, run.permute(2, 1, 0).contiguous(),
                 (bk, bm, bn))):
            case = (f"dispatch backward ({label}, {name} of {prod}: "
                    f"{tuple(a.shape)} @ {tuple(b.shape)})")
            got = K.dispatch.block_matmul(a, b, c, b_, pad_rows=False)
            want = K.dispatch.block_matmul_plain(a, b, c, b_,
                                                 pad_rows=False)
            err, ok = rel_to_max(got, want, TOL)
            check(ok, f"{case}: max|err| {err}")
            b_ms, b_by = bound(*dispatch_work(torch, K, a, b, c, b_))
            record("kernel", name=case, route="fma",
                   source="src/repro_torch/kernels/csrc/dispatch.cu",
                   max_abs_err=err, bitwise=bool(torch.equal(got, want)),
                   ms=cuda_ms(torch, lambda a=a, b=b, c=c, b_=b_:
                              K.dispatch.block_matmul(
                                  a, b, c, b_, pad_rows=False)),
                   plain_ms=cuda_ms(torch, lambda a=a, b=b, c=c, b_=b_:
                                    K.dispatch.block_matmul_plain(
                                        a, b, c, b_, pad_rows=False)),
                   library_ms=cuda_ms(torch, lambda a=a, b=b:
                                      torch.matmul(a, b)),
                   bound_ms=b_ms, bound_by=b_by, tol=TOL,
                   in_kernels_line=False)
            del got, want

    # a pruned grid: about half of w1's 256-blocks zero, so SKIPped; and
    # deepseek's dense-first w1: a ragged width, 42.75 blocks of 256; in
    # bf16 and in float32
    kb, jb = w1.shape[0] // bk, w1.shape[1] // bn
    gone = torch.rand((kb, jb), generator=gen, device=dev) < 0.5
    keep = (~gone).repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    wr32 = operand(cfg.d_model, RAGGED_FF, cfg.d_model ** -0.5)
    gr32 = torch.randn((tokens, RAGGED_FF), generator=gen, device=dev)
    for label in ("bf16", "f32"):
        tag = "" if label == "bf16" else "float32, "
        xs, _, gd, _ = backward_cases[(label, "w1")]
        wh = w1.to(xs.dtype) * keep.to(xs.dtype)
        codes = planned(xs, wh)
        record("dispatch_bwd_pruned_grid", dtype=label,
               w_blocks_zero=int(gone.sum()), w_blocks=kb * jb,
               codes_histogram=torch.bincount(
                   codes.flatten().long(), minlength=4).tolist(),
               active_steps=int((codes != 0).sum()), steps=codes.numel())
        bwd_entry(f"dispatch_bwd ({tag}dx of w1, {int(gone.sum())} of "
                  f"{kb * jb} w blocks zero)", "nt", gd, wh, codes,
                  zero=skipped_rows(codes, *xs.shape)[0])
        bwd_entry(f"dispatch_bwd ({tag}dw of w1, {int(gone.sum())} of "
                  f"{kb * jb} w blocks zero)", "tn", xs, gd, codes)
        if label == "f32":
            fwd_entry(f"dispatch (float32, tiled forward of w1, "
                      f"{int(gone.sum())} of {kb * jb} w blocks zero)",
                      xs, wh, codes)
        wr, gr = wr32.to(xs.dtype), gr32.to(xs.dtype)
        codes = planned(xs, wr)
        bwd_entry(f"dispatch_bwd ({tag}dx, ragged: {tuple(gr.shape)} @ "
                  f"{tuple(wr.shape)}.T)", "nt", gr, wr, codes,
                  zero=skipped_rows(codes, *xs.shape)[0])
        bwd_entry(f"dispatch_bwd ({tag}dw, ragged: {tuple(xs.shape)}.T @ "
                  f"{tuple(gr.shape)})", "tn", xs, gr, codes)
        if label == "f32":
            fwd_entry(f"dispatch (float32, tiled forward, ragged: "
                      f"{tuple(xs.shape)} @ {tuple(wr.shape)})", xs, wr,
                      codes)
    del backward_cases, x, w1, h, w2, xs, gd, wh, wr, gr, wr32, gr32
    torch.cuda.empty_cache()
    a_s = time.perf_counter() - t_phase

    # ---- (b) four steps at full width, dynasparse then dense ----------
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)

    def batch_for_step(step):
        return {k: torch.from_numpy(v).to(dev, torch.long)
                for k, v in pipe.batch_for_step(step).items()}

    def trainer_for(dyn, steps_log, dtype=cfg.dtype):
        c = dataclasses.replace(cfg, dynasparse_ffn=dyn, dtype=dtype)
        bundle = model_zoo.build(c, device=dev)
        opt = AdamW(lr=TRAIN_LR, warmup_steps=20, total_steps=TRAIN_STEPS,
                    state_dtype=c.opt_state_dtype)
        fwd = []

        def loss_fn(params, batch):
            c0 = K.launch_counts()
            loss = bundle.loss_fn(params, batch)
            c1 = K.launch_counts()
            fwd.append({k: c1[k] - c0[k] for k in c1})
            return loss

        step = make_train_step(loss_fn, opt, decay=model_zoo.decay_mask(c))

        def counted(state, batch):
            c0 = K.launch_counts()
            state, metrics = step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            c1 = K.launch_counts()
            total = {k: c1[k] - c0[k] for k in c1}
            steps_log.append({"metrics": metrics, "total": total,
                              "forward": fwd.pop()})
            return state, metrics

        params = bundle.init_params(0)
        return Trainer(counted, batch_for_step,
                       TrainState(params, opt.init(params)),
                       log_every=1)

    logs = {True: [], False: []}
    lines = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = trainer_for(True, logs[True])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    K.reset_launch_counts()
    trainer.run(1, log=lines.append)
    prof = profile_device(torch, lambda: trainer.run(1, log=lines.append),
                          n=1, top=20, warm=False, windows=1)
    trainer.run(TRAIN_STEPS - 2, log=lines.append)
    torch.cuda.synchronize()
    window = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    walls = list(trainer._times)
    per_layer = 3 * cfg.n_layers          # w1, w3, w2 of every layer

    def check_steps(steps_log, label):
        for i, s in enumerate(steps_log):
            fwd_d, tot_d = s["forward"]["dispatch"], s["total"]["dispatch"]
            bwd = s["total"]["dispatch_bwd"]
            check(fwd_d == tot_d == per_layer and bwd == 2 * per_layer
                  and s["forward"]["dispatch_bwd"] == 0
                  and s["total"]["tile_nnz"] == 3 * per_layer
                  and s["forward"]["tile_nnz"] == 3 * per_layer,
                  f"{label} train step {i}: dispatch {fwd_d} forward / "
                  f"{tot_d - fwd_d} backward, dispatch_bwd {bwd}, tile_nnz "
                  f"{s['total']['tile_nnz']} (want {per_layer} / 0, "
                  f"{2 * per_layer}, {3 * per_layer})")
            check(all(np.isfinite(v) for v in s["metrics"].values()),
                  f"{label} train step {i}: {s['metrics']}")

    check_steps(logs[True], "bf16")
    check(window["dispatch"] == per_layer * TRAIN_STEPS
          and window["dispatch_bwd"] == 2 * per_layer * TRAIN_STEPS
          and window["tile_nnz"] == 3 * per_layer * TRAIN_STEPS,
          f"train window launches {window}")
    record("train_dynasparse", arch=cfg.name, steps=TRAIN_STEPS,
           batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
           state_dtype=cfg.opt_state_dtype,
           params=sum(t.numel() for t in leaves(trainer.state.params)),
           metrics=[s["metrics"] for s in logs[True]],
           forward_launches=logs[True][0]["forward"],
           step_launches=logs[True][0]["total"], window_launches=window,
           step_wall_s=walls, init_s=init_s, peak_memory_bytes=peak,
           profiled_step=prof, log=lines, backward_check_s=a_s, card=card)
    del trainer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dense = trainer_for(False, logs[False])
    K.reset_launch_counts()
    dense.run(2, log=lines.append)
    dense.run(TRAIN_STEPS - 2, log=lines.append)
    torch.cuda.synchronize()
    dense_counts = K.launch_counts()
    check(dense_counts["dispatch"] == dense_counts["dispatch_bwd"] == 0
          and dense_counts["tile_nnz"] == 0,
          f"dense training launched {dense_counts}")
    first = {k: (logs[True][0]["metrics"][k], logs[False][0]["metrics"][k])
             for k in ("loss", "grad_norm")}
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in first.items()}
    check(all(r <= TRAIN_REL for r in rel.values()),
          f"dynasparse vs dense first step: {first}")
    record("train_dense", metrics=[s["metrics"] for s in logs[False]],
           step_wall_s=list(dense._times),
           peak_memory_bytes=torch.cuda.max_memory_allocated(),
           first_step_dynasparse_vs_dense=first, first_step_rel=rel,
           tol=TRAIN_REL, card=card)

    # ---- (c) the CLI's restart from a checkpoint -----------------------
    b_s = time.perf_counter() - t_phase - a_s
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        restarted = train_cli.main([
            "--full", "--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
            "--fail-at", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    printed = out.getvalue().splitlines()
    check(any(line.startswith("FAILURE: injected failure at step 2")
              for line in printed) and restarted.step == TRAIN_STEPS,
          f"train CLI: {printed[-3:]}")
    t0 = time.perf_counter()
    back, at = ckpt_lib.restore(str(ckpt_dir), restarted.state)
    restore_s = time.perf_counter() - t0
    saved = tree_lib.flatten(restarted.state)[0]
    check(at == TRAIN_STEPS and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(tree_lib.flatten(back)[0], saved)),
        "restored checkpoint differs from the saved state")
    del back
    final = tree_lib.flatten(restarted.state.params)[0]
    ref = tree_lib.flatten(dense.state.params)[0]
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(final, ref))
    same = all(torch.equal(a, b) for a, b in zip(final, ref))
    check(diff <= RESTART_TOL, f"restarted vs uninterrupted params: {diff}")
    files = sorted(p.name for p in ckpt_dir.iterdir())
    record("train_restart", printed=printed, cli_s=cli_s,
           training_s=b_s,
           restore_check_s=restore_s, steps=restarted.step,
           checkpoint_files=files,
           checkpoint_bytes=sum(f.stat().st_size
                                for f in ckpt_dir.rglob("*.npy")),
           restored_equals_saved=True,
           restarted_vs_uninterrupted_max_abs=diff,
           restarted_equals_uninterrupted=same,
           tol=RESTART_TOL, card=card)
    del restarted, dense
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (d) float32: one warm and one profiled dynasparse step --------
    # (dispatch_bwd's float32 route), held to a dense float32 step on the
    # same weights and batch
    t0 = time.perf_counter()
    logs32 = {True: [], False: [], "walk": []}
    torch.cuda.reset_peak_memory_stats()
    trainer = trainer_for(True, logs32[True], "float32")
    K.reset_launch_counts()
    trainer.run(1, log=lines.append)
    prof32 = profile_device(torch, lambda: trainer.run(1, log=lines.append),
                            n=1, top=20, warm=False, windows=1,
                            count=(NN_KERNEL, WALK_KERNEL))
    torch.cuda.synchronize()
    window32 = K.launch_counts()
    peak32 = torch.cuda.max_memory_allocated()
    walls32 = list(trainer._times)
    check_steps(logs32[True], "float32")
    check(window32["dispatch"] == 2 * per_layer
          and window32["dispatch_bwd"] == 4 * per_layer
          and window32["tile_nnz"] == 6 * per_layer,
          f"float32 train window launches {window32}")
    # the profiled step's forward: every launch on the tiled kernel, none
    # on the walk
    fwd32 = prof32["counted"]
    check(not prof32["complete"] or (fwd32[NN_KERNEL][0] == per_layer
                                     and fwd32[WALK_KERNEL][0] == 0),
          f"float32 step forward launches {fwd32}")
    del trainer
    torch.cuda.empty_cache()
    # the same first step with the forward on the walk, as before
    # block_matmul_nn: the loss and the grad norm must not move a bit
    tiled_fwd = D.block_matmul_nn
    D.block_matmul_nn = lambda x_, y_, c_, b_: D.block_matmul(
        x_, y_, c_, b_, pad_rows=False)[:x_.shape[0], :y_.shape[1]]
    try:
        walk32 = trainer_for(True, logs32["walk"], "float32")
        walk32.run(1, log=lines.append)
    finally:
        D.block_matmul_nn = tiled_fwd
    del walk32
    torch.cuda.empty_cache()
    same32 = {k: logs32[True][0]["metrics"][k] == logs32["walk"][0][
        "metrics"][k] for k in ("loss", "grad_norm")}
    check(all(same32.values()),
          f"float32 first step, tiled vs walk forward: "
          f"{logs32[True][0]['metrics']} vs {logs32['walk'][0]['metrics']}")
    dense32 = trainer_for(False, logs32[False], "float32")
    dense32.run(1, log=lines.append)
    del dense32
    torch.cuda.empty_cache()
    first32 = {k: (logs32[True][0]["metrics"][k],
                   logs32[False][0]["metrics"][k])
               for k in ("loss", "grad_norm")}
    rel32 = {k: abs(a - b) / abs(b) for k, (a, b) in first32.items()}
    check(all(r <= TOL for r in rel32.values()),
          f"float32 dynasparse vs dense first step: {first32}")
    record("train_dynasparse_f32", arch=cfg.name, dtype="float32",
           batch=TRAIN_BATCH, seq=TRAIN_SEQ,
           metrics=[s["metrics"] for s in logs32[True]],
           dense_metrics=[s["metrics"] for s in logs32[False]],
           walk_metrics=[s["metrics"] for s in logs32["walk"]],
           first_step_equals_walk=same32,
           forward_launches_ms={"tiled": fwd32.get(NN_KERNEL),
                                "walk": fwd32.get(WALK_KERNEL)},
           first_step_dynasparse_vs_dense=first32, first_step_rel=rel32,
           tol=TOL, step_launches=logs32[True][0]["total"],
           window_launches=window32, step_wall_s=walls32,
           peak_memory_bytes=peak32, profiled_step=prof32,
           seconds=time.perf_counter() - t0, card=card)
    record("phase", name="11 LM training",
           seconds=time.perf_counter() - t_phase, card=card)
    return {"dispatch_bwd": sum(s["total"]["dispatch_bwd"]
                                for s in logs[True]),
            BWD_F32: window32["dispatch_bwd"],
            FWD_F32: window32["dispatch"]}


# phase 12: the dry run.  (a) the int8 error-feedback all-reduce over a
# one-rank NCCL group on a gradient-shaped tree of llama3.2-1b at full
# width; (b) the padded ops.tile_nnz; (c) the meta count of a cell against
# the same call counted on the card; (d) run_cell over the ten archs x
# four shapes on the production 16x16 mesh
ALLREDUCE_SEED, ALLREDUCE_RES = 0, 1e-2
# (a)'s CPU twin runs on the leaves of layer 0 and the final norm (every
# leaf kind: both projection orientations, the FFN, 1-D scales; 61 M of
# the 1.236 G elements): on all 146 leaves it took 34.9 s of an H100
# machine's host (chip_smoke.py on an H100 80GB HBM3, 700 W), all bitwise
ALLREDUCE_CHECKED = (("layers", 0), ("final_norm",))
# (c): llama3.2-1b's train_4k cost proxy (1 layer period, einsum attention)
# and a prefill, at a batch the card holds: 1 x 4096 tokens
COUNT_BATCH, COUNT_SEQ = 1, 4096
PADDED_TILE_NNZ = "tile_nnz (ops.tile_nnz, padded)"


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_phase(torch, np, K, dev, card, kernel_entry) -> dict:
    """Phase 12: (a) ``compressed_grad_allreduce`` over a one-rank NCCL
    group on random bf16 gradients of llama3.2-1b's full-width param
    shapes (``model_zoo.abstract_params``) with a random float32 residual,
    timed by CUDA events beside its bytes-moved bound, mean and residual
    held bitwise to the same call on the CPU over a one-rank gloo group
    on the leaves of ``ALLREDUCE_CHECKED``; (b) the padded ``ops.tile_nnz`` at 2047 x 8191 bf16 over (256,
    256) tiles, one launch in its own window, exact; (c) the FLOPs that
    ``FlopCounterMode`` counts for llama3.2-1b's train_4k cost proxy and
    a prefill, on meta and on the card, equal, each timed; (d)
    ``dryrun.run_cell`` over the ten archs x four shapes on the
    production 16x16 mesh, each record ``ok`` or ``skipped`` as
    ``cell_supported`` says, every leaf of every argument and output tree
    under a spec.  Returns the launch counts of
    (b)'s window."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import ARCHS, SHAPES, get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.configs.registry import cell_supported
    from repro_torch.distributed import collectives, sharding, shardctx
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainState, make_train_step

    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)

    # ---- (a) the int8 all-reduce on the card --------------------------
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        cpu_group = dist.new_group(ranks=[0], backend="gloo")
        gen = torch.Generator(device=dev)
        gen.manual_seed(ALLREDUCE_SEED)
        shapes = model_zoo.abstract_params(cfg)
        grads = tree_lib.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device=dev, dtype=torch.bfloat16),
            shapes)
        residual = tree_lib.tree_map(lambda p: torch.randn(
            p.shape, generator=gen, device=dev) * ALLREDUCE_RES, shapes)
        g_leaves = tree_lib.flatten(grads)[0]
        elems = sum(g.numel() for g in g_leaves)

        def reduce():
            return collectives.compressed_grad_allreduce(grads, None,
                                                         residual)

        mean, new_res = reduce()
        torch.cuda.synchronize()
        ms = cuda_ms(torch, reduce, target_ms=300.0)
        # each gradient (bf16) and residual (float32) read once, the mean
        # (bf16) and the new residual (float32) written once
        nbytes = 12.0 * elems
        t0 = time.perf_counter()
        same_mean = same_res = True
        mismatched, checked = [], 0
        for (path, g), r, m_, nr in zip(
                tree_lib.flatten_with_path(grads),
                tree_lib.flatten(residual)[0], tree_lib.flatten(mean)[0],
                tree_lib.flatten(new_res)[0]):
            if not any(path[:len(c)] == c for c in ALLREDUCE_CHECKED):
                continue
            checked += g.numel()
            g_c, r_c = g.cpu(), r.cpu()
            m_c, nr_c = collectives.compressed_grad_allreduce(
                g_c, cpu_group, r_c)
            eq_m = torch.equal(m_c, m_.cpu())
            eq_r = torch.equal(nr_c, nr.cpu())
            same_mean &= eq_m
            same_res &= eq_r
            if not (eq_m and eq_r):
                mismatched.append(list(map(str, path)))
        cpu_s = time.perf_counter() - t0
        check(same_mean and same_res,
              f"NCCL compressed all-reduce != CPU: {mismatched[:5]}")
        record("dryrun_allreduce", arch=LM_ARCH, leaves=len(g_leaves),
               elements=elems, grad_dtype="bfloat16",
               residual_scale=ALLREDUCE_RES, mean_bitwise_cpu=same_mean,
               residual_bitwise_cpu=same_res,
               cpu_checked=[list(map(str, c)) for c in ALLREDUCE_CHECKED],
               cpu_checked_elements=checked, ms=ms,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_bytes=nbytes,
               cpu_check_s=cpu_s, group="nccl, 1 rank", card=card)
        del grads, residual, mean, new_res, g_leaves
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    a_s = time.perf_counter() - t_phase

    # ---- (b) the padded ops.tile_nnz ------------------------------------
    tile = (256, 256)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.randn((2047, 8191), generator=gen, device=dev).to(
        torch.bfloat16)
    x[torch.rand(x.shape, generator=gen, device=dev) < 0.5] = 0
    x[:256, :1024] = 0                     # zero tiles
    mb, nb = -(-x.shape[0] // tile[0]), -(-x.shape[1] // tile[1])
    xp = K.dispatch.pad_to(x, *tile).contiguous()
    K.reset_launch_counts()
    counts = ops.tile_nnz(x, tile=tile)
    torch.cuda.synchronize()
    padded_counts = K.launch_counts()
    check(padded_counts["tile_nnz"] == 1 and sum(padded_counts.values()) == 1,
          f"ops.tile_nnz launched {padded_counts}")
    check(tuple(counts.shape) == (mb, nb)
          and torch.equal(counts.cpu(), ops.tile_nnz(x.cpu(), tile=tile))
          and int(counts.sum()) == int(torch.count_nonzero(x)),
          "ops.tile_nnz != its plain version")
    kernel_entry(
        PADDED_TILE_NNZ, "src/repro_torch/kernels/csrc/tile_nnz.cu",
        "src/repro/kernels/ops.py:119",
        lambda: ops.tile_nnz(x, tile=tile),
        lambda: K.profile.tile_nnz_plain(xp, tile)[:mb, :nb],
        lambda: torch.count_nonzero(xp.view(mb, tile[0], nb, tile[1]),
                                    dim=(1, 3)),
        (float(x.numel()), float(x.numel() * x.element_size()
                                 + 4 * mb * nb)),
        lambda g, w: True, units="simt",
        lib_call=f"torch.count_nonzero(xp.view({mb}, 256, {nb}, 256), "
                 "dim=(1, 3)) of x padded beforehand")
    record("dryrun_padded_tile_nnz", shape=list(x.shape), tile=list(tile),
           counts_shape=[mb, nb], launches=padded_counts, exact=True,
           card=card)
    del x, xp

    # ---- (c) the meta count against the card's --------------------------
    mesh = make_production_mesh()
    shape = ShapeCfg("train_4k_1x4096", COUNT_SEQ, COUNT_BATCH, "train")
    pcfg = dryrun._variant(cfg, SHAPES["train_4k"], mode="cost",
                           n_periods=1)
    meta = dryrun.build_cell(pcfg, shape, mesh)
    bundle = model_zoo.build(pcfg, dev)
    params = bundle.init_params(0)
    opt = AdamW(state_dtype=pcfg.opt_state_dtype)
    step = make_train_step(bundle.loss_fn, opt,
                           decay=model_zoo.decay_mask(pcfg))
    gen.manual_seed(13)
    tok = torch.randint(0, cfg.vocab_size, (COUNT_BATCH, COUNT_SEQ),
                        generator=gen, device=dev, dtype=torch.int32)
    cases = {
        "train": (meta.fn, meta.args,
                  lambda: step(TrainState(params, opt.init(params)),
                               {"tokens": tok, "labels": tok})),
    }
    pre = dryrun.build_cell(pcfg, ShapeCfg("prefill_1x4096", COUNT_SEQ,
                                           COUNT_BATCH, "prefill"), mesh)
    cases["prefill"] = (pre.fn, pre.args, lambda: bundle.prefill(
        params, {"tokens": tok}, max_seq=COUNT_SEQ))
    for name, (fn, args, card_fn) in cases.items():
        on_meta = dryrun.count(fn, *args, mesh=mesh)
        on_card = dryrun.count(card_fn, mesh=mesh)
        torch.cuda.synchronize()
        check(on_meta["flops"] == on_card["flops"],
              f"{name}: meta counts {on_meta['flops']} FLOPs, the card "
              f"{on_card['flops']}")
        with shardctx.use_mesh(mesh):
            ms = cuda_ms(torch, card_fn, target_ms=300.0)
        record("dryrun_count", cell=name, arch=LM_ARCH, proxy_layers=
               pcfg.n_layers, batch=COUNT_BATCH, seq=COUNT_SEQ,
               flops_meta=on_meta["flops"], flops_card=on_card["flops"],
               bytes_meta=on_meta["bytes"], bytes_card=on_card["bytes"],
               ms=ms, achieved_tflops=on_card["flops"] / ms / 1e9,
               peak_tflops=PEAK_BF16 / 1e12,
               share_of_peak=on_card["flops"] / ms / 1e9 / (PEAK_BF16 / 1e12),
               card=card)
    del params, bundle, cases, meta, pre
    torch.cuda.empty_cache()
    c_s = time.perf_counter() - t_phase - a_s

    # ---- (d) the sweep on the production mesh ---------------------------
    t_sweep = time.perf_counter()
    walls = {}
    sweep = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
    for arch, shp in sweep:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shp, skip_memory_pass=False)
        walls[f"{arch}|{shp}"] = time.perf_counter() - t0
        if not cell_supported(arch, shp):
            check(rec["status"] == "skipped", f"{arch} {shp}: {rec}")
        else:
            check(rec["status"] == "ok" and rec["flops_per_device"] > 0
                  and rec["memory"]["argument_gib"] > 0,
                  f"{arch} {shp}: {rec}")
            cell = dryrun.build_cell(
                dryrun._variant(get_arch(arch), SHAPES[shp], mode="memory"),
                SHAPES[shp], mesh)
            for tree, sh in ((cell.args, cell.in_shardings),
                             (cell.outputs, cell.out_shardings)):
                leaves, treedef = tree_lib.flatten(tree)
                specs = tree_lib.flatten_up_to(treedef, sh)
                check(len(specs) == len(leaves) and all(
                    isinstance(s, sharding.NamedSharding)
                    for s in specs), f"{arch} {shp}: a leaf without a spec")
        record("dryrun_cell", **rec, host_wall_s=walls[f"{arch}|{shp}"],
               card=card)
    sweep_s = time.perf_counter() - t_sweep
    record("dryrun_sweep", mesh="16x16", cells=len(sweep), host_wall_s=walls,
           total_s=sweep_s, card=card)
    record("phase", name="12 dry run",
           seconds=time.perf_counter() - t_phase, allreduce_s=a_s,
           count_s=c_s, sweep_s=sweep_s, card=card)
    return padded_counts


def wall_ms(torch, fn, n: int = 5) -> float:
    """Median host-clock ms of ``fn`` over ``n`` synchronised calls, after
    one warm-up call."""
    fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


SENTINELS = 32        # spin kernels opening each profiler window
WINDOWS = 4           # profiler windows taken at most, until one is whole


def profile_device(torch, fn, n: int = 3, top: int = 10, warm: bool = True,
                   windows: int = WINDOWS, count: tuple = ()) -> dict:
    """Device busy time and the top device ops of ``fn``, from
    ``torch.profiler`` over ``n`` calls after a warm-up call (none when
    ``warm`` is False, for a call that must run a set number of times, as
    a training step; then ``windows=1``: a window is not taken again) (the
    profiler's own overhead is in ``wall_ms_profiled``); the copy kernels
    (a name holding "copy") are summed apart as ``copy_launches`` and
    ``copy_ms``, and so, under ``counted``, are the device ops whose name
    holds each string of ``count`` ([launches, ms] per call, of all
    events, not only the top ones).

    On the H100 the profiler sometimes drops the first device events of
    a window (a kernel then counts 0.4 or 0.8 launches a call), and no
    margin of time before the calls keeps them.  So each window starts
    with ``SENTINELS`` short spin kernels, left out of the counts.  Every
    call launches a whole number of each kernel, so a window whose counts
    are not multiples of ``n`` still lost events: it is taken again, up
    to ``WINDOWS`` times.  When none is whole, ``complete`` is False and
    the device numbers read "not measured".  How many events a window
    drops grows as the process runs: past 4 after phase 5d's replays,
    hence ``SENTINELS`` 32."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        return us / 1e3 / n

    for window in range(1, windows + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3 / n
        # device-side events only: an aten op's own row repeats the time
        # of the kernels it launched
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA and dev_ms(e) > 0
                  and "spin_kernel" not in e.key]
        complete = bool(events) and all(e.count % n == 0 for e in events)
        if complete:
            break
    if not complete:
        return {"wall_ms_profiled": wall_ms, "device_busy_ms": "not measured",
                "idle_share": "not measured", "windows": window,
                "complete": False, "top_device_ops": [],
                "counted": {c: "not measured" for c in count}}
    busy = sum(dev_ms(e) for e in events)
    ops = sorted(events, key=dev_ms, reverse=True)[:top]
    copies = [e for e in events if "copy" in e.key.lower()]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "windows": window,
            "complete": True,
            "copy_launches": sum(e.count for e in copies) / n,
            "copy_ms": sum(dev_ms(e) for e in copies),
            "counted": {c: [sum(e.count for e in events if c in e.key) / n,
                            sum(dev_ms(e) for e in events if c in e.key)]
                        for c in count},
            "top_device_ops": [[e.key[:80], dev_ms(e), e.count / n]
                               for e in ops]}


def dispatch_work(torch, K, x, y, codes, block) -> tuple:
    """(flops, bytes) the dispatch kernel's non-SKIP steps need on these
    inputs: every step's tile products at 16x16x16 over the row tiles that
    hold x's m rows, and every x / y tile that at least one step reads
    (SPMM steps counted by occupancy), read once, plus the code grid and
    the m rows of output written once (the padding rows are not needed)."""
    bm, bk, bn = block
    I, J, Kb = codes.shape
    m = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, Kb * bk - x.shape[1],
                                     0, I * bm - m))
    yp = torch.nn.functional.pad(y, (0, J * bn - y.shape[1],
                                     0, Kb * bk - y.shape[0]))
    tm, tk, tn = bm // 16, bk // 16, bn // 16
    ox = K.dispatch.tile_occupancy(xp).reshape(I, tm, Kb, tk).float()
    oy = K.dispatch.tile_occupancy(yp).reshape(Kb, tk, J, tn).float()
    # row tiles of each row block that hold one of x's rows
    real = (-(-m // 16) - tm * torch.arange(I, device=x.device)).clamp(
        0, tm).float()                                      # (I,)
    c = codes.long()
    gemm, spdmm, spmm = (c == 1).float(), (c == 2).float(), (c == 3).float()
    rx = ox.sum(1)                                          # (I, Kb, tk)
    cy = oy.sum(3)                                          # (Kb, tk, J)
    pairs = torch.einsum("ikt,ktj->ijk", rx, cy)            # (I, J, Kb)
    tile = 2.0 * 16 ** 3
    flops = tile * ((gemm * real[:, None, None]).sum() * tk * tn
                    + (spdmm * rx.sum(2)[:, None, :]).sum() * tn
                    + (spmm * pairs).sum())
    any_g = (gemm.sum(1) > 0).float()                       # (I, Kb)
    any_s = ((spdmm + spmm).sum(1) > 0).float()
    x_tiles = ((any_g * real[:, None]).sum() * tk
               + ((1 - any_g) * any_s * rx.sum(2)).sum())
    gd = ((gemm + spdmm).sum(0) > 0).float().T              # (Kb, J)
    sp = (spmm.sum(0) > 0).float().T
    y_tiles = (gd[:, None, :, None] + (1 - gd)[:, None, :, None]
               * sp[:, None, :, None] * oy).sum()
    nbytes = (x.element_size() * (x_tiles + y_tiles) * 256
              + 4.0 * (codes.numel() + m * J * bn))
    return float(flops), float(nbytes)


def tiled_work(torch, layout, a, b, codes, block) -> tuple:
    """(flops, bytes) the tiled kernels need on these inputs
    (``dispatch_bwd``'s ``nt`` and ``tn`` products, the float32 forward's
    ``nn``): each active step's block product over the rows, columns and
    depth that lie inside the operands (a tile no step reaches is written
    as zeros), every operand block that one active step reads, read once,
    the code grid read and the result (the operands' type) written
    once."""
    bm, bk, bn = block
    I, J, Kb = codes.shape
    run = (codes != 0).double()                             # (I, J, Kb)

    def extent(n, edge, count):
        return (n - edge * torch.arange(count, device=codes.device)
                ).clamp(0, edge).double()

    if layout == "nt":      # g (m, n), w (kd, n): dx (m, kd)
        m, n, kd = a.shape[0], a.shape[1], b.shape[0]
    else:                   # x (m, kd) with g (m, n) or y (kd, n)
        m, kd, n = a.shape[0], a.shape[1], b.shape[1]
    r, c, k = extent(m, bm, I), extent(n, bn, J), extent(kd, bk, Kb)
    flops = 2.0 * torch.einsum("ijk,i,j,k->", run, r, c, k)
    x_blocks = torch.einsum("ik,i,k->", (run.sum(1) > 0).double(), r, k)
    w_blocks = torch.einsum("jk,k,j->", (run.sum(0) > 0).double(), k, c)
    g_blocks = torch.einsum("ij,i,j->", (run.sum(2) > 0).double(), r, c)
    size = a.element_size()     # operands and result: one type
    read, written = {"nt": (g_blocks + w_blocks, m * kd),
                     "tn": (g_blocks + x_blocks, kd * n),
                     "nn": (x_blocks + w_blocks, m * n)}[layout]
    nbytes = size * (read + written) + 4.0 * codes.numel()
    return float(flops), float(nbytes)

if __name__ == "__main__":
    sys.exit(main())
