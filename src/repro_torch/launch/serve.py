"""Serving entry point: batched prefill + decode with the slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 16 --prompt-len 32 --new-tokens 16 [--dynasparse] \\
      [--prune 0.1] [--device cpu]

Port of ``repro.launch.serve`` (the smoke config of the arch, random
seeded weights).  Runs on the GPU unless ``--device cpu``.
``--dynasparse`` routes FFN matmuls through the dynamic K2P dispatcher;
pair with ``--prune <density>`` to sparsify the FFN weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import model_zoo
from repro_torch.serving.engine import Request, ServeEngine

FFN_LEAVES = ("w1", "w2", "w3")


def prune_ffn(params: Dict, density: float, rng=None) -> Dict:
    """Magnitude-prune the FFN weight matrices to ``density`` (paper sec
    VIII-B); returns new params, the input is not modified.

    One threshold per FFN weight name over all layers: the reference
    prunes each stacked (n_periods, d, f) leaf at once, so the port pools
    its per-layer weights the same way.  The threshold is the
    ``(size - k)``-th smallest magnitude (``np.partition``'s pick), kept
    with ``>=``.  ``rng`` is unused (the reference's signature).
    """
    del rng
    layers = [dict(lp, ffn=dict(lp["ffn"])) for lp in params["layers"]]
    for name in FFN_LEAVES:
        ws = [lp["ffn"][name] for lp in layers if name in lp["ffn"]]
        if not ws:
            continue
        mags = torch.cat([w.float().abs().reshape(-1) for w in ws])
        size = mags.numel()
        k = max(int(size * density), 1)
        thr = torch.kthvalue(mags, size - k + 1).values
        del mags
        for lp in layers:
            w = lp["ffn"][name]
            lp["ffn"][name] = torch.where(w.float().abs() >= thr, w,
                                          torch.zeros_like(w))
    return dict(params, layers=layers)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--dynasparse", action="store_true")
    ap.add_argument("--prune", type=float, default=1.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    if args.dynasparse:
        cfg = dataclasses.replace(cfg, dynasparse_ffn=True)
    bundle = model_zoo.build(cfg, device=args.device)
    params = bundle.init_params(0)
    rng = np.random.default_rng(0)
    if args.prune < 1.0:
        params = prune_ffn(params, args.prune, rng)
    engine = ServeEngine(bundle, params, slots=args.slots,
                         max_seq=args.prompt_len + args.new_tokens,
                         temperature=args.temperature)
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 size=(args.prompt_len,)).astype(np.int32),
                    max_new_tokens=args.new_tokens, request_id=i)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens) for r in results)
    print(f"arch={cfg.name} dynasparse={args.dynasparse} prune={args.prune} "
          f"device={bundle.device}")
    print(f"served {len(results)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok / dt:.1f} tok/s on {bundle.device})")
    for r in results[:3]:
        print(f"  req {r.request_id}: {r.tokens[:12]}...")


if __name__ == "__main__":
    main()
