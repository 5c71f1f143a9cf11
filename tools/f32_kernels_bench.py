#!/usr/bin/env python3
"""The float32 tiled ``dispatch`` kernel (``kernels/csrc/dispatch_bwd_f32.cu``:
the backward's nt and tn products and the training forward's nn) and the
float32 flash attention (``kernels/csrc/flash_attention.cu``,
``rt_flash_attention_f32``) beside variants of their design and their
PyTorch calls, on one CUDA card.

    python3 tools/f32_kernels_bench.py [--reps 2]

Builds the kernels as ``kernels/build.py`` does, and each variant of a
source into ``build/f32_variants/`` (one ``nvcc`` each, in parallel):

* ``dispatch_bwd_f32`` ``warp4x8``: each warp holds 4 x 8 threads of the
  16 x 16 thread grid instead of 2 x 16, so a warp's 16-byte shared loads
  of the two operands read 4 and 8 distinct addresses instead of 2 and 16;
* ``dispatch_bwd_f32`` ``stage64``: 3 stages of 64 contraction steps
  instead of 4 of 32, so a 256-deep block costs 4 barriers, not 8;
* ``dispatch_bwd_f32`` ``nn_lds32``: the nn layout reads x from shared
  memory one step at a time (8 4-byte loads a step, 8 registers) instead
  of 4 steps of a row per 16-byte load (2 loads a step, 32 registers);
* ``dispatch_bwd_f32`` ``acc_out_2cta`` (and with ``nn_lds32``): the
  running sums kept in the output between contraction blocks instead of
  in registers, so a thread holds only the open block's partials; 128
  registers at most, two CTAs an SM, 3 stages;
* ``flash_attention`` ``keys64``: key tiles of 64 (4 keys a thread) at
  every D, where the kernel takes 128 (8 keys a thread, so each 16-byte
  load of Q feeds 8 keys) at D <= 64;
* ``flash_attention`` ``mask_all``: every key tile masked element by
  element, where the kernel masks only the tiles that reach past the
  CTA's first unmasked key.

Each ``dispatch_bwd_f32`` variant must equal the kernel bitwise (it moves
threads or stages, not one sum); each flash variant must stay within 3e-4
of the largest |want| of the plain version (the tile width moves the
online softmax's rescaling points).  Then all are timed by CUDA events in
turns (``--reps`` rounds): llama3.2-1b's four FFN backward products and
its two forward products (w1 and w3, w2) at 2048 tokens and (256, 256,
256) blocks on an all-GEMM grid and on a grid with half the steps
SKIPped, beside ``torch.matmul`` of the dense product; the
causal scoring shape (2 x 32 heads over 8 kv heads x 2048 x 64) and a D =
128 one (2 x 16 / 4 x 2048 x 128), beside ``scaled_dot_product_attention``
in float32 (kv repeated).  Prints one JSON line per case and writes them,
with the card's name and power limit, to
``chiprun_out/f32_kernels_bench.json``.
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
# dispatch_bwd_f32 nn: x read one step at a time
NN_LDS32 = ((
    "          float4 a4[TM];\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < TM; ++i)\n"
    "            a4[i] = *reinterpret_cast<const float4*>(\n"
    "                as + row_of(i) * RPAD + k4 * 4);\n"
    "#pragma unroll\n"
    "          for (int kk = 0; kk < 4; ++kk) {\n"
    "            float a[TM], b[TNN];\n"
    "#pragma unroll\n"
    "            for (int i = 0; i < TM; ++i) a[i] = "
    "rt::lane_of(a4[i], kk);\n",
    "#pragma unroll\n"
    "          for (int kk = 0; kk < 4; ++kk) {\n"
    "            float a[TM], b[TNN];\n"
    "#pragma unroll\n"
    "            for (int i = 0; i < TM; ++i)\n"
    "              a[i] = as[row_of(i) * RPAD + k4 * 4 + kk];\n"),)
# dispatch_bwd_f32: the running sums kept in the output between blocks
# (each thread reads back only what it wrote), so a thread holds only the
# open block's partials: at most 128 registers, two CTAs an SM (3 stages,
# twice the CTAs); the last sums are read back into registers for the
# kernel's own store
ACC_OUT = (
    ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)"),
    ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
    ("    float acc[TM][TNN], part[TM][TNN];\n",
     "    float part[TM][TNN];\n"
     "    bool first = true;   // no block in the output yet\n"),
    ("      for (int j = 0; j < TNN; ++j) acc[i][j] = part[i][j] = 0.f;\n",
     "      for (int j = 0; j < TNN; ++j) part[i][j] = 0.f;\n"),
    ("            acc[i][j] += part[i][j];\n",
     "            const long r = row0 + row_of(i), c = col0 + col_of(j);\n"
     "            if (r < p.rows && c < p.cols) {\n"
     "              float* o = p.out + r * p.cols + c;\n"
     "              *o = (first ? 0.f : *o) + part[i][j];\n"
     "            }\n"),
    ("        cs = 0;\n        ct = next_active(ct + 1);\n",
     "        first = false;\n"
     "        cs = 0;\n        ct = next_active(ct + 1);\n"),
    ("    rt::cp_async_wait<0>();\n",
     "    rt::cp_async_wait<0>();\n"
     "    float acc[TM][TNN];\n"
     "#pragma unroll\n"
     "    for (int i = 0; i < TM; ++i)\n"
     "#pragma unroll\n"
     "      for (int j = 0; j < TNN; ++j) {\n"
     "        const long r = row0 + row_of(i), c = col0 + col_of(j);\n"
     "        acc[i][j] = first || r >= p.rows || c >= p.cols\n"
     "                        ? 0.f : p.out[r * p.cols + c];\n"
     "      }\n"),
    ("  kernel<<<ctas, THREADS, smem, s>>>(p);",
     "  kernel<<<min(2 * ctas, p.row_tiles * p.col_tiles), THREADS, smem,\n"
     "           s>>>(p);"),
)
# source -> {variant: ((text in csrc/<source>.cu, its replacement), ...)}
VARIANTS = {
    "dispatch_bwd_f32": {
        "warp4x8": ((
            "  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;\n",
            "  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;\n"
            "  const int ty = w / 2 * 4 + lane / 8, tx = w % 2 * 8 + lane % 8;"
            "\n"),),
        "stage64": (("constexpr int KS = 32;", "constexpr int KS = 64;"),
                    ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")),
        "nn_lds32": NN_LDS32,
        "acc_out_2cta": ACC_OUT,
        "acc_out_2cta_lds32": ACC_OUT + NN_LDS32},
    "flash_attention": {
        "keys64": (("  constexpr int BK = D <= 64 ? 128 : 64;       // keys "
                    "of a tile\n", "  constexpr int BK = 64;\n"),),
        "mask_all": (("    const bool edge = t0 + BK > clean;\n",
                      "    const bool edge = true;\n"),)},
}
SYMBOL = {"dispatch_bwd_f32": "rt_dispatch_bwd_f32",
          "flash_attention": "rt_flash_attention_f32"}


def build_variants(build) -> dict:
    """{(source, variant): the variant's C entry point}, built in
    parallel."""
    out = ROOT / "build" / "f32_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for source, variants in VARIANTS.items():
        src = (build.CSRC / f"{source}.cu").read_text()
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {source}/{name}: its text "
                                       "is not in the source")
                text = text.replace(old, new)
            cu, so = out / f"{source}_{name}.cu", out / f"lib{source}_{name}.so"
            cu.write_text(text)
            procs.append(((source, name), so, subprocess.Popen(
                [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o",
                 str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)))
    fns = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_bytes(log)     # ptxas: registers
        if proc.returncode:
            raise RuntimeError(f"variant {key}:\n{log.decode()}")
        fns[key] = getattr(ctypes.CDLL(str(so)), SYMBOL[key[0]])
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("f32_kernels_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import repro_torch.kernels as K
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    build.build_all()
    variants = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []

    def using(source, fn_ptr, call):
        """``call()`` with ``source``'s entry point replaced by ``fn_ptr``
        (None: the kernel's own)."""
        key = (source, SYMBOL[source])
        real = build._functions.get(key)
        if fn_ptr is None:
            return call()
        argtypes = real.argtypes
        fn_ptr.argtypes, fn_ptr.restype = argtypes, ctypes.c_int
        build._functions[key] = fn_ptr
        try:
            return call()
        finally:
            build._functions[key] = real

    def timed(source, run, named):
        """{name: [ms per round]} of the kernel and its variants, in
        turns."""
        times = {"kernel": []}
        for _ in range(args.reps):
            times["kernel"].append(cs.cuda_ms(torch, run))
            for name, fn_ptr in named.items():
                times.setdefault(name, []).append(
                    using(source, fn_ptr, lambda: cs.cuda_ms(torch, run)))
        return times

    # ---- the float32 tiled dispatch: backward and forward --------------
    B = K.dispatch_bwd
    bwd = {name: f for (src, name), f in variants.items()
           if src == "dispatch_bwd_f32"}
    B.block_matmul_nt(*(torch.zeros((64, 64), device=dev),) * 2,
                      torch.ones((1, 1, 1), dtype=torch.int32, device=dev),
                      (64, 64, 64))        # declares the entry point
    for grid in ("gemm", "half SKIPped"):
        for layout, m, kd, n in (("nt", 2048, 2048, 8192),
                                 ("tn", 2048, 2048, 8192),
                                 ("nn", 2048, 2048, 8192),
                                 ("nt", 2048, 8192, 2048),
                                 ("tn", 2048, 8192, 2048),
                                 ("nn", 2048, 8192, 2048)):
            I, J, Kb = m // 256, n // 256, kd // 256
            codes = torch.ones((I, J, Kb), dtype=torch.int32, device=dev)
            if grid != "gemm":
                codes[torch.rand((I, J, Kb), generator=gen,
                                 device=dev) < 0.5] = 0
            g = torch.randn((m, n), generator=gen, device=dev)
            if layout == "nt":
                a, b = g, torch.randn((kd, n), generator=gen, device=dev)
                fn, lib = B.block_matmul_nt, lambda: torch.matmul(a, b.T)
            elif layout == "nn":
                a = torch.randn((m, kd), generator=gen, device=dev)
                b = torch.randn((kd, n), generator=gen, device=dev)
                fn = K.dispatch.block_matmul_nn
                lib = lambda: torch.matmul(a, b)  # noqa: E731
            else:
                a, b = torch.randn((m, kd), generator=gen, device=dev), g
                fn, lib = B.block_matmul_tn, lambda: torch.matmul(a.T, b)
            run = lambda: fn(a, b, codes, BLOCK)  # noqa: E731
            want = run()
            for name, f in bwd.items():
                got = using("dispatch_bwd_f32", f, run)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"variant {name} != kernel at "
                                         f"{layout} {m}x{kd}x{n} {grid}")
            flops, nbytes = cs.tiled_work(torch, layout, a, b, codes, BLOCK)
            row = {"kernel": ("dispatch (float32, tiled forward)"
                              if layout == "nn" else "dispatch_bwd (float32)"),
                   "layout": layout,
                   "shape": [m, kd, n], "grid": grid,
                   "active_steps": int((codes != 0).sum()),
                   "bound_ms": cs.bound(flops, nbytes)[0],
                   "ms": timed("dispatch_bwd_f32", run, bwd),
                   "matmul_ms": cs.cuda_ms(torch, lib), "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)

    # ---- the float32 flash attention ----------------------------------
    fl = {name: f for (src, name), f in variants.items()
          if src == "flash_attention"}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b_, h, hkv, s, d in ((2, 32, 8, 2048, 64), (2, 16, 4, 2048, 128)):
        q = torch.randn((b_, h, s, d), generator=gen, device=dev)
        k = torch.randn((b_, hkv, s, d), generator=gen, device=dev)
        v = torch.randn((b_, hkv, s, d), generator=gen, device=dev)
        kr, vr = (t.repeat_interleave(h // hkv, 1) for t in (k, v))
        run = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
        want = K.flash_attention.flash_attention_plain(q, k, v, causal=True)
        errs = {}
        for name, f in {"kernel": None, **fl}.items():
            got = using("flash_attention", f, run)
            errs[name] = float((got - want).abs().max())
            if errs[name] > 3e-4 * float(want.abs().max()):
                raise AssertionError(f"flash {name}: max|err| {errs[name]}")
        pairs = b_ * h * s * (s + 1) / 2
        row = {"kernel": "flash_attention (float32)",
               "shape": [b_, h, hkv, s, d], "max_abs_err": errs,
               "bound_ms": cs.bound(4.0 * d * pairs, 4.0 * (
                   2 * q.numel() + k.numel() + v.numel()))[0],
               "ms": timed("flash_attention", run, fl),
               "sdpa_ms": cs.cuda_ms(torch, lambda: sdpa(
                   q, kr, vr, is_causal=True)), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "f32_kernels_bench.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
