#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/``), holds every kernel against its plain PyTorch version on the
card at the main path's shapes, then drives GraphSAGE on full-size
CiteSeer (3327 vertices, 3703 features, hidden 16, 6 classes, random
seeded weights) through both engines of the port, checks the results
against a float64 dense oracle of the same model, and times everything
with CUDA events.  Each path resets the kernels' launch counters just
before it runs and reads them just after; a kernel of a path that was
never launched fails the run.

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
MODEL_TOL = 2e-4      # engine outputs (tests/test_unified_executor.py:90)
PEAK_FP32 = 67e12     # H100 SXM, FP32 outside the tensor cores, FLOP/s
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


def bound(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
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

    def kernel_entry(name, source, replaces, fn, plain, lib, work, ok_err):
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        check(close(got, want, TOL) and ok_err(got, want),
              f"{name}: kernel disagrees with its plain version "
              f"(max|err|={err})")
        flops, nbytes = work
        b_ms, b_by = bound(flops, nbytes)
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": 0, "max_abs_err": err,
                 "ms": cuda_ms(torch, fn), "plain_ms": cuda_ms(torch, plain),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None if lib is None else cuda_ms(torch, lib)}
        kernels_line[name] = entry
        record("kernel", **entry, flops=flops, bytes=nbytes)

    def small_checks(name, fn_pairs):
        for label, fn, plain in fn_pairs:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            check(close(got, want, TOL), f"{name} {label}: max|err|={err}")
            record("kernel_case", kernel=name, case=label, max_abs_err=err)

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
    def wall(fn, n=5):
        fn()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    for strategy in analyzer.STRATEGIES:
        eng = runtime.DynasparseEngine(strategy=strategy)
        record("wall", model="sage", dataset="CI", engine="per-kernel",
               strategy=strategy, median_ms=wall(lambda: sage.run(eng)),
               card=card)
    for collect in (True, False):
        fx = runtime.FusedModelExecutor(collect_report=collect)
        record("wall", model="sage", dataset="CI", engine="fused",
               strategy="dynamic", collect_report=collect,
               median_ms=wall(lambda: fx.run(sage.compiled, sage.tensors)),
               card=card)
    K.reset_launch_counts()
    sage.run(runtime.DynasparseEngine())
    record("launches_per_inference", engine="per-kernel", strategy="dynamic",
           counts=K.launch_counts())
    record("profile", **profile_fused(torch, runtime, sage), card=card)

    kernels_line["gemm"]["launches"] = main_counts["gemm"]
    kernels_line["spdmm"]["launches"] = main_counts["spdmm"]
    kernels_line["dispatch"]["launches"] = main_counts["dispatch"]
    kernels_line["csr_spmm"]["launches"] = csr_counts["csr_spmm"]
    kernels_line["spmm"]["launches"] = prim_counts["spmm"]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORDS, indent=1))
    print(card)
    print(json.dumps({"kernels": list(kernels_line.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_fused(torch, runtime, bundle, n: int = 3) -> dict:
    """Device busy time and the top device ops of the fused executor
    without reports, from ``torch.profiler`` over ``n`` inferences (the
    profiler's own overhead is in ``wall_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fx = runtime.FusedModelExecutor(collect_report=False)
    fx.run(bundle.compiled, bundle.tensors)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fx.run(bundle.compiled, bundle.tensors)
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
    return {"engine": "fused", "collect_report": False,
            "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy if events else "not measured",
            "idle_share": 1.0 - busy / wall_ms if events else "not measured",
            "top_device_ops": [[e.key[:80], dev_ms(e), e.count / n]
                               for e in top]}


def dispatch_work(torch, K, x, y, codes, block) -> tuple:
    """(flops, bytes) the dispatch kernel's non-SKIP steps need on these
    inputs: every step's tile products at 16x16x16, and every x / y tile
    that at least one step reads (SPMM steps counted by occupancy), read
    once, plus the code grid and the output written once."""
    bm, bk, bn = block
    I, J, Kb = codes.shape
    xp = torch.nn.functional.pad(x, (0, Kb * bk - x.shape[1],
                                     0, I * bm - x.shape[0]))
    yp = torch.nn.functional.pad(y, (0, J * bn - y.shape[1],
                                     0, Kb * bk - y.shape[0]))
    tm, tk, tn = bm // 16, bk // 16, bn // 16
    ox = K.dispatch.tile_occupancy(xp).reshape(I, tm, Kb, tk).float()
    oy = K.dispatch.tile_occupancy(yp).reshape(Kb, tk, J, tn).float()
    c = codes.long()
    gemm, spdmm, spmm = (c == 1).float(), (c == 2).float(), (c == 3).float()
    rx = ox.sum(1)                                          # (I, Kb, tk)
    cy = oy.sum(3)                                          # (Kb, tk, J)
    pairs = torch.einsum("ikt,ktj->ijk", rx, cy)            # (I, J, Kb)
    tile = 2.0 * 16 ** 3
    flops = tile * (gemm.sum() * tm * tk * tn
                    + (spdmm * rx.sum(2)[:, None, :]).sum() * tn
                    + (spmm * pairs).sum())
    any_g = (gemm.sum(1) > 0).float()                       # (I, Kb)
    any_s = ((spdmm + spmm).sum(1) > 0).float()
    x_tiles = (any_g[:, None, :, None] + (1 - any_g)[:, None, :, None]
               * any_s[:, None, :, None] * ox).sum()
    gd = ((gemm + spdmm).sum(0) > 0).float().T              # (Kb, J)
    sp = (spmm.sum(0) > 0).float().T
    y_tiles = (gd[:, None, :, None] + (1 - gd)[:, None, :, None]
               * sp[:, None, :, None] * oy).sum()
    nbytes = 4.0 * ((x_tiles + y_tiles) * 256 + codes.numel()
                    + I * bm * J * bn)
    return float(flops), float(nbytes)


if __name__ == "__main__":
    sys.exit(main())
