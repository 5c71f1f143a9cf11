#!/usr/bin/env python3
"""Host-side copy rates behind ``train/checkpoint.py``'s design, on a card.

    python3 tools/host_copy_bench.py [--gib 3] [--dir build/host_copy_bench]

Copies ``--gib`` GiB of float32 tensors (64 MiB each) between the card and
the host the ways a checkpoint can: into fresh pageable memory (``.to``),
into pinned memory (first allocation, then from PyTorch's host cache),
``np.save`` from one thread and from 8, ``np.load`` into fresh memory and
as a copy-on-write map, each followed by the copy to the card.  Prints
seconds and GiB/s per way; the files are removed at the end.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CHUNK = 16 * 1024 * 1024          # float32 values per tensor: 64 MiB


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=int, default=3)
    ap.add_argument("--dir", default="build/host_copy_bench")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("host_copy_bench: no CUDA device")
    os.makedirs(args.dir, exist_ok=True)
    ts = [torch.randn(CHUNK, device="cuda") for _ in range(16 * args.gib)]
    torch.cuda.synchronize()

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"{label}: {dt:.3f} s, {args.gib / dt:.2f} GiB/s", flush=True)
        return out

    def path(i):
        return os.path.join(args.dir, f"t{i}.npy")

    def pinned():
        return [torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t) for t in ts]

    hosts = timed("D2H into fresh pageable memory",
                  lambda: [t.to("cpu", copy=True) for t in ts])
    first = timed("D2H into pinned memory, first allocation", pinned)
    del first
    timed("D2H into pinned memory, from the host cache", pinned)
    arrs = [h.numpy() for h in hosts]
    timed("np.save, one thread",
          lambda: [np.save(path(i), a) for i, a in enumerate(arrs)])
    with ThreadPoolExecutor(8) as pool:
        timed("np.save, 8 threads",
              lambda: list(pool.map(lambda i: np.save(path(i), arrs[i]),
                                    range(len(arrs)))))
    timed("np.load into fresh memory + H2D",
          lambda: [torch.from_numpy(np.load(path(i))).to("cuda")
                   for i in range(len(arrs))])
    timed("np.load mmap_mode='c' + H2D",
          lambda: [torch.from_numpy(np.load(path(i), mmap_mode="c")).to(
              "cuda") for i in range(len(arrs))])
    shutil.rmtree(args.dir, ignore_errors=True)


if __name__ == "__main__":
    main()
