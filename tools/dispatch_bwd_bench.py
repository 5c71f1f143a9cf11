#!/usr/bin/env python3
"""The bf16 ``dispatch`` backward (``kernels/csrc/dispatch_bwd.cu``) beside
two variants of its design and ``torch.matmul``, on one CUDA card.

    python3 tools/dispatch_bwd_bench.py [--reps 2]

Builds the kernel as ``kernels/build.py`` does, and two variants of its
source into ``build/dispatch_bwd_variants/``:

* ``static``: each CTA takes tiles b, b + CTAs, ... instead of taking the
  next one from the queue;
* ``registers``: the bf16 result stored from registers instead of staged
  in shared memory and written by TMA.

Each is checked against the kernel (bitwise: the variants change the
schedule and the stores, not one sum), then all are timed by CUDA events
in turns (``--reps`` rounds) on llama3.2-1b's four FFN backward products
at 2048 tokens and (256, 256, 256) blocks (dx = g @ w.T, dw = x.T @ g for
w1 2048 -> 8192 and w2 8192 -> 2048), over three code grids: all GEMM,
half of w's blocks zero (their steps SKIPped), and half of the steps
SKIPped at random.  ``torch.matmul`` of the dense product (the operand
transposed as a view) is the yardstick.  Prints one JSON line per case
and writes them, with the card's name and power limit, to
``chiprun_out/dispatch_bwd_bench.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK = (256, 256, 256)
# each variant: (text in csrc/dispatch_bwd.cu, its replacement)
VARIANTS = {
    "static": ("      if (lane == 0) next = gridDim.x + atomicAdd(p.next_tile, "
               "1);\n", "      next = tile + gridDim.x;\n"),
    "registers": ("  const int tma_out = !out_f32 && cols % 8 == 0 && "
                  "((uintptr_t)out & 15) == 0;\n",
                  "  const int tma_out = 0;\n"),
}


def build_variants(build) -> dict:
    """{name: rt_dispatch_bwd} of each variant, built in parallel."""
    src = (build.CSRC / "dispatch_bwd.cu").read_text()
    out = ROOT / "build" / "dispatch_bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text is not in the source")
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(src.replace(old, new))
        procs.append((name, so, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    fns = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}:\n{log.decode()}")
        fns[name] = ctypes.CDLL(str(so)).rt_dispatch_bwd
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dispatch_bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import dispatch_bwd as B

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    kernel = build.function("dispatch_bwd", "rt_dispatch_bwd", B.C_ARGS)
    fns = build_variants(build)
    for f in fns.values():
        f.argtypes, f.restype = B.C_ARGS, ctypes.c_int
    fns = {"kernel": kernel, **fns}
    dev = torch.device("cuda")
    queue = torch.empty((1,), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def launch(fn, layout, a, b, codes, out):
        s = B.bwd_launch(layout, *out.shape, tuple(codes.shape), BLOCK,
                         build.sm_count(dev))
        build.check(fn(B.LAYOUTS.index(layout), a.data_ptr(), *a.shape,
                       a.stride(0), b.data_ptr(), *b.shape, b.stride(0),
                       codes.data_ptr(), queue.data_ptr(), out.data_ptr(), 0,
                       *out.shape, s.tile_m, s.tile_n, s.row_tiles,
                       s.col_tiles, s.ctas, s.group, s.row_edge, s.col_edge,
                       s.depth, s.steps, s.rs, s.cs, s.ts,
                       build.stream(a)), "dispatch_bwd")

    lines = []
    for prod, (m, kd, n) in (("w1", (2048, 2048, 8192)),
                             ("w2", (2048, 8192, 2048))):
        x = torch.randn((m, kd), generator=gen, device=dev).bfloat16()
        w = torch.randn((kd, n), generator=gen, device=dev).bfloat16()
        g = torch.randn((m, n), generator=gen, device=dev).bfloat16()
        I, J, K = m // BLOCK[0], n // BLOCK[2], kd // BLOCK[1]
        zero_w = torch.rand((K, J), generator=gen, device=dev) < 0.5
        grids = {
            "all GEMM": torch.ones((I, J, K), dtype=torch.int32, device=dev),
            "half of w's blocks zero": (~zero_w).T[None].expand(
                I, J, K).to(torch.int32).contiguous(),
            "half of the steps SKIPped": (torch.rand(
                (I, J, K), generator=gen, device=dev) >= 0.5).to(torch.int32),
        }
        for grid, codes in grids.items():
            for layout, a, b, lib in (
                    ("nt", g, w, lambda: torch.matmul(g, w.T)),
                    ("tn", x, g, lambda: torch.matmul(x.T, g))):
                shape = (m, kd) if layout == "nt" else (kd, n)
                outs = {v: torch.empty(shape, dtype=torch.bfloat16,
                                       device=dev) for v in fns}
                for v, fn in fns.items():
                    launch(fn, layout, a, b, codes, outs[v])
                torch.cuda.synchronize()
                same = {v: bool(torch.equal(o, outs["kernel"]))
                        for v, o in outs.items()}
                if not all(same.values()):
                    raise AssertionError(f"{prod} {grid} {layout}: a variant "
                                         f"differs from the kernel: {same}")
                ms = {v: [] for v in [*fns, "torch.matmul"]}
                for _ in range(args.reps):
                    for v, fn in fns.items():
                        ms[v].append(chip_smoke.cuda_ms(
                            torch, lambda fn=fn, o=outs[v]: launch(
                                fn, layout, a, b, codes, o)))
                    ms["torch.matmul"].append(chip_smoke.cuda_ms(torch, lib))
                flops, nbytes = chip_smoke.tiled_work(torch, layout, a, b,
                                                      codes, BLOCK)
                rec = {"product": f"{'dx' if layout == 'nt' else 'dw'} of "
                       f"{prod}", "grid": grid,
                       "active_steps": float((codes != 0).float().mean()),
                       "ms": ms, "bound_ms": chip_smoke.bound(
                           flops, nbytes, chip_smoke.PEAK_BF16)[0],
                       "variants_bitwise_the_kernel": True, "card": card}
                print(json.dumps(rec), flush=True)
                lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dispatch_bwd_bench.json").write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
