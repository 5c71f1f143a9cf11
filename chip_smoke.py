#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds every kernel against its plain PyTorch version on the
card at the shapes its path gives it, then drives the port's paths:

* GraphSAGE on full-size CiteSeer (3327 vertices, 3703 features, hidden
  16, 6 classes, random seeded weights) through both engines, checked
  against a float64 dense oracle (GCN, row-CSR and ``ops.matmul`` too);
* llama3.2-1b at full width (16 layers, d_model 2048, 32/8 heads, d_ff
  8192, vocab 128256, bf16, random seeded weights): the scoring forward
  (``loss_fn``) with ``attn_impl="flash"`` on 2 x 2048 tokens, checked
  against the ``chunked`` attention; and ``ServeEngine`` on 8 requests of
  128 prompt tokens + 16 new tokens with FFN weights pruned to density
  0.1, once with ``dynasparse_ffn`` (tile_nnz + dispatch at (256, 256,
  256)) and once dense; then the smoke config's dynasparse == dense
  tokens and decode == full-forward logits on the card.

bf16 operands run on the tensor-core routes of ``dispatch`` and
``flash_attention`` (``mma.sync``), float32 on the FP32 FMA routes; each
``kernel`` record names its route (``mma``, ``fma``, or ``simt`` for the
integer ``tile_nnz``).  The bf16 ``dispatch`` is timed on both FFN
products (w1: 2048 -> 8192, w2: 8192 -> 2048) at prefill and decode
shapes and checked at decode row counts 1, 4, 17 and 300.

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

import dataclasses
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

RECORDS: list = []


def record(kind: str, **fields) -> None:
    rec = {"record": kind, **fields}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


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
    from repro_torch.core import analyzer, formats, profiler, runtime
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
                     line_name=None):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err, ok = agree(got, want, tol)
        check(ok and ok_err(got, want),
              f"{name}: kernel disagrees with its plain version "
              f"(max|err|={err}, tol={tol})")
        flops, nbytes = work
        b_ms, b_by = bound(flops, nbytes, peak)
        entry = {"name": name, "route": "cuda", "units": units,
                 "source": source,
                 "replaces": replaces, "launches": 0, "max_abs_err": err,
                 "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None if lib is None else cuda_ms(torch, lib)}
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
        record("kernel", **{**entry, "route": units},
               device_ms=dev["device_busy_ms"],
               device_ops=dev["top_device_ops"][:4],
               flops=flops, bytes=nbytes, tol=tol, in_kernels_line=line)

    def small_checks(name, fn_pairs, tol=TOL):
        for label, fn, plain in fn_pairs:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err, ok = agree(got, want, tol)
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

    # gemm: the gemm strategy's Aggregate product
    kernel_entry(
        "gemm", "src/repro_torch/kernels/csrc/gemm.cu",
        "src/repro/kernels/gemm.py:37",
        lambda: K.gemm.gemm(Ap, Hp), lambda: K.gemm.gemm_plain(Ap, Hp),
        dense_lib, (2.0 * mm * kk * nn, 4.0 * (mm * kk + kk * nn + mm * nn)),
        lambda g, w: True)
    small_checks("gemm", [
        ("update 3328x3712x16", lambda: K.gemm.gemm(Hp, W1p),
         lambda: K.gemm.gemm_plain(Hp, W1p)),
        ("16x16x16", lambda: K.gemm.gemm(Ap[:16, :16].contiguous(),
                                          Hp[:16, :16].contiguous()),
         lambda: K.gemm.gemm_plain(Ap[:16, :16], Hp[:16, :16]))])

    # spdmm: the s1/s2 strategies' Aggregate product over Block-CSR(A)
    xb = formats.dense_to_bcsr(Ap, (16, 16))
    nzt = int(xb.counts.sum())
    used_rows = int(torch.unique(xb.col_idx[
        torch.arange(xb.col_idx.shape[1], device=dev)[None, :]
        < xb.counts[:, None]]).numel())
    kernel_entry(
        "spdmm", "src/repro_torch/kernels/csrc/spdmm.cu",
        "src/repro/kernels/spdmm.py:50",
        lambda: K.spdmm.spdmm(xb, Hp), lambda: K.spdmm.spdmm_plain(xb, Hp),
        dense_lib,
        (2.0 * nzt * 16 * 16 * nn,
         4.0 * (nzt * 256 + nzt + xb.counts.numel() + used_rows * 16 * nn
                + mm * nn)),
        lambda g, w: True)
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
        lambda: K.spmm.spmm_plain(xb, yb, plan), dense_lib,
        (2.0 * steps * 16 ** 3,
         4.0 * (nzt * 256 + int(yb.counts.sum()) * 256 + 2 * steps
                + plan.counts.numel() + mm * nn)),
        lambda g, w: True)
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
    n_out = H0.shape[1]
    a_csr = A.to_sparse_csr()
    kernel_entry(
        "csr_spmm", "src/repro_torch/kernels/csrc/csr_spmm.cu",
        "src/repro/kernels/csr_spmm.py:43",
        lambda: K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, H0),
        lambda: K.csr_spmm.csr_spmm_plain(ell.values, ell.cols,
                                          ell.row_counts, H0),
        lambda: torch.sparse.mm(a_csr, H0),
        (2.0 * nnz * n_out,
         8.0 * nnz + 4.0 * (A.shape[0] + uniq * n_out + A.shape[0] * n_out)),
        lambda g, w: True)
    z_ell = formats.dense_to_ell(torch.zeros_like(A), 0)
    narrow = H0[:, :16].contiguous()          # the second Aggregate's width
    small_checks("csr_spmm", [
        ("ELL(A) x (3327, 16)", lambda: ops.csr_spmm(A, narrow, rmax=rmax),
         lambda: A @ narrow),
        ("rmax 0", lambda: ops.csr_spmm(z_ell, narrow),
         lambda: torch.zeros((A.shape[0], 16), device=dev))])

    # dispatch: random code grids at the main path's block shapes, then the
    # planner's own grid for the first Aggregate (timed)
    rng = np.random.default_rng(0)

    def rand_codes(I, J, Kb):
        return torch.from_numpy(rng.integers(0, 4, size=(I, J, Kb))
                                .astype(np.int32)).to(dev)

    cases = []
    for blk, (x, y) in (((64, 64, 16), (A, H0)), ((32, 32, 16), (A, H0)),
                        ((16, 16, 16), (H0, W1)),
                        ((64, 64, 16), (torch.zeros_like(A), H0))):
        I = -(-x.shape[0] // blk[0])
        Kb = -(-x.shape[1] // blk[1])
        J = -(-y.shape[1] // blk[2])
        c = rand_codes(I, J, Kb)
        cases.append((f"random codes {blk} {tuple(x.shape)}x{tuple(y.shape)}",
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
        dispatch_work(torch, K, A, H0, codes, blk), lambda g, w: True)

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
    record("main_path_launches", model="sage", dataset="CI",
           counts=main_counts)
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
    record("csr_path_launches", counts=csr_counts)
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

    # ---------------- phases 7-9: the LM paths (llama3.2-1b) --------------
    lm_counts = lm_paths(torch, np, K, dev, card, A, kernel_entry,
                         small_checks)

    kernels_line["gemm"]["launches"] = main_counts["gemm"]
    kernels_line["spdmm"]["launches"] = main_counts["spdmm"]
    kernels_line["dispatch"]["launches"] = main_counts["dispatch"]
    kernels_line["csr_spmm"]["launches"] = csr_counts["csr_spmm"]
    kernels_line["spmm"]["launches"] = prim_counts["spmm"]
    kernels_line["tile_nnz"]["launches"] = lm_counts["serve"]["tile_nnz"]
    kernels_line["flash_attention"]["launches"] = \
        lm_counts["score"]["flash_attention"]
    kernels_line[LM_DISPATCH]["launches"] = lm_counts["serve"]["dispatch"]
    check(set(K.KERNEL_MODULES) | {LM_DISPATCH} == set(kernels_line)
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


LM_ARCH = "llama3.2-1b"
SCORE_BATCH, SCORE_SEQ = 2, 2048
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 128, 16
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_DENSITY = 4, 144, 0.1
# the bf16 (tensor-core) dispatch kernel's entry in the kernels line: its
# launches are every dispatch launch of the serving path (prefill and
# decode; w1, w2 and w3), its times those of the most frequent call, a
# decode step's FFN w1 product
LM_DISPATCH = "dispatch (bf16, tensor cores)"


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
    pruned = prune_ffn(params, SERVE_DENSITY)
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
        lambda: K.profile.tile_nnz_plain(w1, (256, 256)), None,
        nnz_work(w1, (256, 256)), lambda g, w: True, units="simt")
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
    sp = prune_ffn(sb.init_params(0), SERVE_DENSITY)
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


def profile_device(torch, fn, n: int = 3) -> dict:
    """Device busy time and the top device ops of ``fn``, from
    ``torch.profiler`` over ``n`` calls after a warm-up call (the
    profiler's own overhead is in ``wall_ms_profiled``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        return us / 1e3 / n

    # device-side events only: an aten op's own row repeats the time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
              and dev_ms(e) > 0]
    busy = sum(dev_ms(e) for e in events)
    top = sorted(events, key=dev_ms, reverse=True)[:10]
    return {"wall_ms_profiled": wall_ms,
            "device_busy_ms": busy if events else "not measured",
            "idle_share": 1.0 - busy / wall_ms if events else "not measured",
            "top_device_ops": [[e.key[:80], dev_ms(e), e.count / n]
                               for e in top]}


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


if __name__ == "__main__":
    sys.exit(main())
