#!/usr/bin/env python3
"""Per-unit timeline of the row-CSR kernel on the card.

    python3 tools/csr_spmm_trace.py

Builds a copy of ``src/repro_torch/kernels/csrc/csr_spmm.cu`` whose hub
CTAs and warps stamp ``%globaltimer`` when they start and finish (into
``build/csr_spmm_trace/``), runs it on the CSR phase's two Aggregates of
full-size CiteSeer (ELL of A_mean at rmax 576, @ H0 and @ H1) and prints,
per shape, one JSON line (also kept in ``build/csr_spmm_trace/``): the
launch shape, the kernel's span and, for the hub units, the heavy units
and the light units by row length, how long a unit took and when the
units started (microseconds from the first start).
The profiler and ``ncu`` cannot see inside a kernel on that machine; this
shows which units set its time.  Needs one CUDA card; the stamps add a few
instructions per unit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "csr_spmm_trace"
SLOTS = 1 << 17
STAMPS = '''
__device__ unsigned long long g_t0[SLOTS], g_t1[SLOTS];
__device__ __forceinline__ unsigned long long g_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
'''.replace("SLOTS", str(SLOTS))
# (text in the kernel, what replaces it): the stamp index is the warp's
# global id, so a hub CTA's is its first warp's
HUB = "             (blockIdx.x % hub_strips) * WARP, rmax, n, ldo);\n"
HEAVY = ("    walk_strip<G, 1, 32>(hs, y, out, row, (u % hstrips) * G, n, ldo,"
         " p);\n")
LIGHT = "    walk_strip<G, 1, G>(rs, y, out, row, 0, n, ldo, p);\n}\n"
RUN = "  if (run != nullptr && *run == 0) return;\n  const int hub_strips"
PATCHES = [
    ("namespace {\n\nconstexpr unsigned FULL",
     STAMPS + "namespace {\n\nconstexpr unsigned FULL"),
    (RUN, RUN.replace("  const int hub_strips", "")
     + "  const unsigned long long t0_ = g_now();\n"
     "  const long w_ = (long)blockIdx.x * (blockDim.x / WARP)"
     " + threadIdx.x / WARP;\n"
     "#define STAMP if (threadIdx.x % WARP == 0 && w_ < " + str(SLOTS)
     + ") { g_t0[w_] = t0_; g_t1[w_] = g_now(); }\n  const int hub_strips"),
    (HUB, HUB + "    STAMP\n"),
    (HEAVY, HEAVY + "    STAMP\n"),
    (LIGHT, LIGHT.replace("}\n", "  STAMP\n}\n")),
]
TAIL = '''
extern "C" int rt_csr_trace(unsigned long long* t0, unsigned long long* t1) {
  cudaMemcpyFromSymbol(t0, g_t0, sizeof(g_t0));
  return (int)cudaMemcpyFromSymbol(t1, g_t1, sizeof(g_t1));
}

extern "C" int rt_csr_trace_clear() {
  void* p;
  cudaGetSymbolAddress(&p, g_t0);
  cudaMemset(p, 0, sizeof(g_t0));
  cudaGetSymbolAddress(&p, g_t1);
  return (int)cudaMemset(p, 0, sizeof(g_t1));
}
'''


def build(kbuild) -> ctypes.CDLL:
    src = (kbuild.CSRC / "csr_spmm.cu").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"csr_spmm.cu changed: no single {anchor!r}")
        src = src.replace(anchor, text)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "csr_spmm_trace.cu").write_text(src + TAIL)
    so = OUT / "libcsr_spmm_trace.so"
    subprocess.run([kbuild._nvcc(), *kbuild.FLAGS, "-I", str(kbuild.CSRC),
                    "-o", str(so), str(OUT / "csr_spmm_trace.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def summary(t0, t1, mask):
    if not mask.any():
        return None
    d = (t1 - t0)[mask] / 1e3
    return {"units": int(mask.sum()),
            "us_p50": float(np.percentile(d, 50)),
            "us_p90": float(np.percentile(d, 90)), "us_max": float(d.max()),
            "start_us_p50": float(np.percentile(t0[mask], 50) / 1e3),
            "end_us_max": float(t1[mask].max() / 1e3)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("csr_spmm_trace: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import formats
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import csr_spmm as C
    from repro_torch.models import gnn

    lib = build(kbuild)
    fn = lib.rt_csr_spmm
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_long] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sage = gnn.build_dense("sage", "CI", scale=1.0, device=dev)
    t = sage.tensors
    A, H0 = t["A_mean"], t["H0"]
    H1 = torch.relu(A @ H0 @ t["Wneigh1"] + H0 @ t["Wself1"]).contiguous()
    ell = formats.dense_to_ell(A, 576)
    m, rmax = ell.values.shape
    counts = ell.row_counts.cpu().numpy()
    records = []
    for label, y in (("N1 ELL(A) @ H0", H0), ("N2 ELL(A) @ H1", H1)):
        n = y.shape[1]
        s = C.csr_launch(m, n, rmax, kbuild.sm_count(dev))
        out = torch.empty((m, n), device=dev)
        order = torch.empty(m, dtype=torch.int32, device=dev)

        def run():
            rc = fn(ell.values.data_ptr(), ell.cols.data_ptr(),
                    ell.row_counts.data_ptr(), y.data_ptr(), out.data_ptr(),
                    order.data_ptr(), None, 0, m, rmax, n, n, s.group,
                    s.hub_rows, s.heavy_rows, s.heavy_strips, s.strips,
                    s.per_cta, s.ctas, kbuild.stream(y))
            if rc:
                raise RuntimeError(f"csr_spmm trace launch: cudaError {rc}")

        ms = chip_smoke.cuda_ms(torch, run)
        torch.cuda.synchronize()
        lib.rt_csr_trace_clear()        # warps that do not stamp read 0
        run()
        torch.cuda.synchronize()
        t0 = np.zeros(SLOTS, np.uint64)
        t1 = np.zeros(SLOTS, np.uint64)
        lib.rt_csr_trace(t0.ctypes.data, t1.ctypes.data)
        warps = s.ctas * s.per_cta
        t0, t1 = t0[:warps].astype(np.int64), t1[:warps].astype(np.int64)
        ok = t1 > 0
        t0, t1 = t0 - t0[ok].min(), t1 - t0[ok].min()
        w = np.arange(warps)
        hub = ok & (w < s.hub_ctas * s.per_cta) & (w % s.per_cta == 0)
        u = w - s.hub_ctas * s.per_cta
        heavy = ok & (u >= 0) & (u < s.heavy_units)
        light = ok & (u >= s.heavy_units)
        groups = s.groups(m)
        rank = np.clip(s.heavy_rows + ((u - s.heavy_units) % max(groups, 1))
                       * s.rows_per_warp, 0, m - 1)
        lc = counts[order.cpu().numpy()[rank]]
        rec = {"record": "csr_spmm_trace", "case": label, "card": card,
               "launch": vars(s), "event_ms": ms,
               "span_us": float(t1[ok].max() / 1e3),
               "hub": summary(t0, t1, hub), "heavy": summary(t0, t1, heavy),
               "light": {f"{lo}-{hi} slots": summary(
                   t0, t1, light & (lc >= lo) & (lc <= hi))
                   for lo, hi in ((0, 1), (2, 2), (3, 4), (5, 8), (9, rmax))}}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    (OUT / "csr_spmm_trace.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
