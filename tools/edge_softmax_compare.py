#!/usr/bin/env python3
"""GAT's ``edge_softmax`` on full-size CiteSeer, for one or more trees of
the repository, on one CUDA card.

    python3 tools/edge_softmax_compare.py [--tree DIR ...] [--sweep]

For each tree (default: this one), in a process of its own that imports
that tree's ``src/repro_torch``: the GAT bundle of ``chip_smoke.py``
(seed 0, 2 layers x 2 heads, threshold 0.02), layer 1 head 1's operands
(A, Z1h1) from a warm-up inference, then

* alpha's SHA-256 (float32) from ``edge_softmax`` on A @ Z1h1;
* its time by CUDA events and its kernels' device time (``torch.profiler``);
* one fused GAT inference: its ``tile_nnz`` and ``edge_softmax`` launches,
  device busy time, idle share and top device ops (``chip_smoke.py``'s
  ``profile_device``).

``--sweep`` also times this tree's kernel at 4, 8 and 16 rows a CTA.  Give
the trees in turns (parent, change, change, parent) to compare two
versions on one card.  Prints one JSON line per tree and writes them to
``chiprun_out/edge_softmax_compare.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(tree: Path, sweep: bool) -> dict:
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import repro_torch.kernels as K
    from repro_torch.core import runtime
    from repro_torch.core.ir import KernelType
    from repro_torch.models import gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    E = K.edge_softmax
    gat = gnn.build_dense("gat", "CI", scale=1.0, device=dev)
    cm, tensors = gat.compiled, gat.tensors
    att = next(k for k in cm.graph.kernels
               if k.kernel_type == KernelType.ATTENTION)
    ob = (att.scheme.n2, att.scheme.n2)
    warm, _ = runtime.FusedModelExecutor(keep_intermediates=True).run(
        cm, tensors)
    A, Z = tensors["A"], warm["Z1h1"]
    asrc, adst = tensors["a_src1h1"], tensors["a_dst1h1"]
    del warm
    fused_counts = "out_block" in inspect.signature(E.edge_softmax).parameters
    kw = dict(slope=att.att_slope, threshold=att.att_threshold)
    if fused_counts:
        kw["out_block"] = ob

    def es():
        return E.edge_softmax(A, Z, asrc, adst, **kw)

    out = es()
    alpha = out[0] if fused_counts else out
    torch.cuda.synchronize()
    rec = {"tree": str(tree), "fused_counts": fused_counts,
           "out_block": list(ob), "alpha_nnz": int(torch.count_nonzero(alpha)),
           "alpha_sha256": hashlib.sha256(
               alpha.cpu().numpy().tobytes()).hexdigest(),
           "ms": chip_smoke.cuda_ms(torch, es)}
    prof = chip_smoke.profile_device(torch, es, n=20)
    rec["device_ms"] = prof["device_busy_ms"]
    rec["device_ops"] = prof["top_device_ops"][:3]
    if sweep and fused_counts:
        rec["sweep"] = {}
        for rows in (4, 8, 16):
            E.MAX_ROWS = rows
            E.edge_launch.cache_clear()
            got = es()[0]
            torch.cuda.synchronize()
            p_ = chip_smoke.profile_device(torch, es, n=20)
            rec["sweep"][rows] = {
                "ms": chip_smoke.cuda_ms(torch, es),
                "device_ms": p_["device_busy_ms"],
                "alpha_equal": bool(torch.equal(got, alpha))}
        E.MAX_ROWS = 16
        E.edge_launch.cache_clear()
    del out, alpha
    fx = runtime.FusedModelExecutor(collect_report=False)
    fx.run(cm, tensors)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    fx.run(cm, tensors)
    torch.cuda.synchronize()
    rec["fused_launches"] = K.launch_counts()
    rec["fused_wall_ms"] = chip_smoke.wall_ms(torch,
                                              lambda: fx.run(cm, tensors))
    rec["fused_profile"] = chip_smoke.profile_device(
        torch, lambda: fx.run(cm, tensors), top=8)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path,
                    help="a checkout of the repository (repeatable)")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(measure(args.one.resolve(), args.sweep)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("edge_softmax_compare: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    recs = []
    for i, tree in enumerate(args.tree or [ROOT]):
        cmd = [sys.executable, __file__, "--one", str(tree)]
        if args.sweep:
            cmd.append("--sweep")
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        rec = {"run": i + 1, "card": card,
               **json.loads(done.stdout.strip().splitlines()[-1])}
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "edge_softmax_compare.json").write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
