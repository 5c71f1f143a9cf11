"""End-to-end Dynasparse GNN inference on the port (the counterpart of
``examples/gnn_inference.py``).

Materializes a (scaled) Table VI graph, compiles the model, runs real
numerics through the per-kernel engine under every mapping strategy and
through the fused whole-model executor, and prints per-strategy primitive
histograms, modeled FPGA latency, walls, executor-cache hits, the
cross-strategy ``max|err|`` and whether fused == per-kernel bitwise.

    PYTHONPATH=src python -m repro_torch.infer --model sage --ds CI --scale 1.0

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions instead.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import hw
from repro_torch.core import analyzer, runtime
from repro_torch.models import gnn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="sage", choices=list(gnn.GNN_MODELS))
    ap.add_argument("--ds", default="CI")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    bundle = gnn.build_dense(args.model, args.ds, scale=args.scale,
                             device=args.device)
    g = bundle.graph.spec
    dev = bundle.tensors["H0"].device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"== {args.model.upper()} on {args.ds} (scale {args.scale}) on "
          f"{name} ==")
    print(f"|V|={g.n_vertices} |E|={g.n_edges} f={g.f_in} "
          f"density(A)={g.density_a:.4f} density(H0)={g.density_h0:.4f}")
    print(f"partitions: N1={bundle.compiled.partition.n1} "
          f"N2={bundle.compiled.partition.n2}")

    freq = hw.ALVEO_U250.freq_hz
    outs = {}
    for strategy in ("gemm", "s1", "s2", "dynamic"):
        eng = runtime.DynasparseEngine(strategy=strategy)
        bundle.run(eng)                     # first run: builds the kernels
        out, rep = bundle.run(eng)          # cache hits: re-launch only
        outs[strategy] = out
        print(f"{strategy:8s} hist[SKIP,GEMM,SPDMM,SPMM]={rep.histogram} "
              f"modeled={rep.total_seconds(freq) * 1e3:.4f}ms "
              f"wall={rep.wall_seconds * 1e3:.2f}ms "
              f"plan-bookkeeping={rep.k2p_wall_seconds * 1e3:.2f}ms "
              f"exec-cache hit/miss={eng.cache_hits}/{eng.cache_misses}")
    err = max(float((outs[s] - outs["gemm"]).abs().max())
              for s in analyzer.STRATEGIES if s != "gemm")
    print(f"value preservation across strategies: max|err|={err:.2e}")

    fused = runtime.FusedModelExecutor(strategy="dynamic")
    fused.run(bundle.compiled, bundle.tensors)
    env, rep = fused.run(bundle.compiled, bundle.tensors)
    last = bundle.compiled.graph.kernels[-1].out
    same = bool(torch.equal(env[last], outs["dynamic"]))
    print(f"fused    hist[SKIP,GEMM,SPDMM,SPMM]={rep.histogram} "
          f"wall={rep.fused_wall_seconds * 1e3:.2f}ms "
          f"k2p-overlapped={rep.k2p_exposed_seconds(freq) * 1e6:.1f}us "
          f"(serial {rep.k2p_seconds * 1e6:.1f}us) "
          f"traces={fused.trace_count} bitwise==per-kernel: {same}")


if __name__ == "__main__":
    main()
