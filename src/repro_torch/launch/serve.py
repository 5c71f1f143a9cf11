"""Serving entry point: batched prefill + decode with the slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 16 --prompt-len 32 --new-tokens 16 [--dynasparse] \\
      [--prune 0.1] [--device cpu]

Port of ``repro.launch.serve`` (the smoke config of the arch, random
seeded weights); ``--arch`` takes any of the ten archs.  Runs on the GPU
unless ``--device cpu``.  ``--dynasparse`` routes FFN matmuls through the
dynamic K2P dispatcher; pair with ``--prune <density>`` to sparsify the
FFN weights.  Decoder-only archs are served by ``ServeEngine``; an
encoder-decoder arch (whisper) decodes greedily from seeded stub frames
(``prompt-len * dec_ratio`` of them) through the bundle's prefill and
decode step, since ``ServeEngine`` refuses it as the reference's fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import model_zoo
from repro_torch.serving.engine import Request, Result, ServeEngine

# FFN weight names the reference prunes (its substring match on a leaf's
# path: dense and dense-first MLPs, shared experts, routed experts and
# sLSTM's up/down projections)
FFN_LEAVES = ("w1", "w2", "w3", "we1", "we2", "we3")
STACKS = ("layers", "enc_layers", "dec_layers")
BF16_BINS = 1 << 15      # magnitude bit patterns of a bfloat16

Path = Tuple[str, ...]


def _paths(tree: Dict, prefix: Path = ()) -> List[Path]:
    out = []
    for k, v in tree.items():
        out += (_paths(v, prefix + (k,)) if isinstance(v, dict)
                else [prefix + (k,)])
    return out


def _get(tree: Dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def leaf_groups(params: Dict, period: int
                ) -> List[List[Tuple[str, int, Path]]]:
    """The FFN weights of ``params``, one group per leaf of the reference's
    scanned layout: each ``dense_first`` layer's own; one per (period
    position, path) of ``layers`` over its periods (``period`` is the
    config's ``layer_period``, the length of the pattern the reference's
    ``stack`` holds one leaf per position of); one per path of
    ``enc_layers`` and of ``dec_layers``.  Entries are (stack key, layer
    index, path within the layer)."""
    groups = []
    for i, lp in enumerate(params.get("dense_first", [])):
        groups += [[("dense_first", i, path)] for path in _paths(lp)
                   if path[-1] in FFN_LEAVES]
    for key in STACKS:
        layers = params.get(key) or []
        if not layers:
            continue
        step = period if key == "layers" else 1
        for posn in range(step):
            groups += [[(key, j, path)
                        for j in range(posn, len(layers), step)]
                       for path in _paths(layers[posn])
                       if path[-1] in FFN_LEAVES]
    return groups


def magnitude_threshold(ws: Sequence[torch.Tensor], density: float
                        ) -> torch.Tensor:
    """The reference's threshold over the weights ``ws`` pooled: with
    ``size`` values and ``k = max(int(size * density), 1)``, the
    ``(size - k)``-th smallest magnitude, counting from 0 (``np.partition``'s
    pick), as a float32 scalar.

    bfloat16 weights count their magnitude bit patterns into a 32768-bin histogram, one ``bincount`` per tensor, and
    read the value off its cumulative sum: exact, and no pooled copy of
    the weights (a full-width DeepSeek expert leaf holds 4.8 G values).
    Float32 weights take ``torch.kthvalue`` of the pooled magnitudes.
    """
    size = sum(w.numel() for w in ws)
    rank = size - max(int(size * density), 1)
    if all(w.dtype == torch.bfloat16 for w in ws):
        hist = None
        for w in ws:
            bits = (w.contiguous().view(torch.int16) & 0x7FFF).reshape(-1)
            h = torch.bincount(bits.int(), minlength=BF16_BINS)
            hist = h if hist is None else hist + h
        b = torch.searchsorted(torch.cumsum(hist, 0),
                               torch.tensor(rank, device=hist.device),
                               right=True)
        pattern = b.to(torch.int16).reshape(1)
        return pattern.view(torch.bfloat16)[0].float()
    mags = torch.cat([w.float().abs().reshape(-1) for w in ws])
    return torch.kthvalue(mags, rank + 1).values


def prune_ffn(params: Dict, density: float, rng=None, *, period: int
              ) -> Dict:
    """Magnitude-prune the FFN weight matrices of ``params`` to ``density``
    (paper sec VIII-B), one threshold per reference leaf (:func:`leaf_groups`
    with the config's ``layer_period``), each weight kept where its
    magnitude is at least the threshold.

    Zeroes the pruned weights in place (a full-width model's pruned copy
    would not fit beside it) and returns ``params``.  ``rng`` is unused
    (the reference's signature).
    """
    del rng
    for group in leaf_groups(params, period):
        ws = [_get(params[key][j], path) for key, j, path in group]
        thr = magnitude_threshold(ws, density)
        for w in ws:
            w.masked_fill_(~(w.float().abs() >= thr), 0)
    return params


def generate_encdec(bundle: model_zoo.ModelBundle, params: Dict,
                    frames: torch.Tensor, prompts: np.ndarray,
                    new_tokens: int) -> List[Result]:
    """Greedy decoding of an encoder-decoder bundle: one prefill over the
    frames and the (equal-length) prompts, then ``new_tokens - 1`` decode
    steps."""
    dev = bundle.device
    toks = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    vocab = bundle.cfg.vocab_size
    with torch.inference_mode():
        logits, caches = bundle.prefill(
            params, {"frames": frames, "tokens": toks},
            max_seq=prompts.shape[1] + new_tokens)
        out = [logits[:, :vocab].argmax(-1)]
        for i in range(new_tokens - 1):
            logits, caches = bundle.decode_step(
                params, caches, out[-1][:, None], prompts.shape[1] + i)
            out.append(logits[:, :vocab].argmax(-1))
    gen = torch.stack(out, 1).cpu().numpy().astype(np.int32)
    return [Result(i, g) for i, g in enumerate(gen)]


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
        params = prune_ffn(params, args.prune, rng,
                           period=cfg.layer_period)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=(args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    if cfg.encdec is not None:
        gen = torch.Generator(device=bundle.device)
        gen.manual_seed(0)
        frames = torch.randn(
            (args.requests, args.prompt_len * cfg.encdec.dec_ratio,
             cfg.d_model), generator=gen, device=bundle.device,
            dtype=cfg.jdtype)
        results = generate_encdec(bundle, params, frames, np.stack(prompts),
                                  args.new_tokens)
    else:
        engine = ServeEngine(bundle, params, slots=args.slots,
                             max_seq=args.prompt_len + args.new_tokens,
                             temperature=args.temperature)
        results = engine.generate(
            [Request(p, max_new_tokens=args.new_tokens, request_id=i)
             for i, p in enumerate(prompts)])
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
