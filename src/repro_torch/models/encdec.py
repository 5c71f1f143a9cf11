"""Whisper-style encoder-decoder backbone (audio family).

Port of ``repro.models.encdec``.  The conv frontend is the reference's
stub: callers pass precomputed frame embeddings (B, S_enc, D), what
whisper's two conv layers would emit.  Sinusoidal positions on both
sides, LayerNorm, GELU MLPs, bidirectional encoder attention, causal
decoder self-attention and cross-attention.

Params keep one dict per layer (``enc_layers``, ``dec_layers``: the
reference's unrolled layout; ``model_zoo.params_from_reference`` also
takes its ``enc_stack``/``dec_stack``).  Caches: ``{"dec": [{"k", "v",
"xk", "xv"}, ...]}``, self k/v written in place at ``pos``, cross k/v
filled once by :func:`prefill`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import gqa_attention, gqa_kv, init_gqa
from repro_torch.models.layers import (Gen, chunked_cross_entropy,
                                       device_of, init_mlp, mlp, norm,
                                       randn)
from repro_torch.models.transformer import _init_norm

ENC_DECODE_LEN = 3000


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    # (-ln 1e4 * i) / (half - 1) in float32, left to right as the
    # reference's expression evaluates
    ln = torch.log(torch.tensor(10000.0, device=positions.device))
    freqs = torch.exp(-ln * torch.arange(half, device=positions.device)
                      / max(half - 1, 1))
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_block(gen: Gen, cfg: ModelConfig, dtype) -> Dict:
    dev = device_of(gen)
    return {"ln1": _init_norm(cfg, dev), "mix": init_gqa(gen, cfg, dtype),
            "ln2": _init_norm(cfg, dev),
            "ffn": init_mlp(gen, cfg, cfg.d_ff, dtype)}


def _init_dec_block(gen: Gen, cfg: ModelConfig, dtype) -> Dict:
    dev = device_of(gen)
    return {"ln1": _init_norm(cfg, dev), "mix": init_gqa(gen, cfg, dtype),
            "lnx": _init_norm(cfg, dev), "cross": init_gqa(gen, cfg, dtype),
            "ln2": _init_norm(cfg, dev),
            "ffn": init_mlp(gen, cfg, cfg.d_ff, dtype)}


def init_params(cfg: ModelConfig, gen: Gen) -> Dict:
    dtype = cfg.jdtype
    dev = device_of(gen)
    return {
        "embed": randn(gen, (cfg.padded_vocab, cfg.d_model), dtype, 0.02),
        "enc_final": _init_norm(cfg, dev),
        "dec_final": _init_norm(cfg, dev),
        "enc_layers": [_init_enc_block(gen, cfg, dtype)
                       for _ in range(cfg.encdec.n_enc_layers)],
        "dec_layers": [_init_dec_block(gen, cfg, dtype)
                       for _ in range(cfg.n_layers)],
    }


def _enc_block(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    o, _ = gqa_attention(norm(x, p["ln1"], cfg.norm_eps), p["mix"], cfg,
                         positions=None, causal=False)
    x = x + o
    return x + mlp(norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states."""
    _, s, d = frames.shape
    x = frames + sinusoid(torch.arange(s, device=frames.device),
                          d)[None].to(frames.dtype)
    for p in params["enc_layers"]:
        x = _enc_block(x, p, cfg)
    return norm(x, params["enc_final"], cfg.norm_eps)


def _dec_block(x, p, cfg: ModelConfig, *, positions, cache, pos, cross_kv):
    """cross_kv: (k, v) from the encoder states (this layer's)."""
    h = norm(x, p["ln1"], cfg.norm_eps)
    o, _ = gqa_attention(h, p["mix"], cfg, positions=positions,
                         cache=cache, pos=pos, causal=True)
    x = x + o
    hx = norm(x, p["lnx"], cfg.norm_eps)
    o, _ = gqa_attention(hx, p["cross"], cfg, positions=None, causal=False,
                         kv=cross_kv)
    x = x + o
    return x + mlp(norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)


def decoder_forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None, *,
                    caches: Optional[Dict] = None, pos: int = 0
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Cross K/V come from ``enc_out`` (scoring) or from the cache
    (serving)."""
    _, s = tokens.shape
    positions = pos + torch.arange(s, device=tokens.device)
    x = params["embed"][tokens] + sinusoid(
        positions, cfg.d_model)[None].to(cfg.jdtype)
    layer_caches = (caches["dec"] if caches is not None
                    else [None] * cfg.n_layers)
    for p, c in zip(params["dec_layers"], layer_caches):
        if enc_out is not None:
            cross_kv = gqa_kv(enc_out, p["cross"], cfg, None)
        else:
            cross_kv = (c["xk"], c["xv"])
        x = _dec_block(x, p, cfg, positions=positions, cache=c, pos=pos,
                       cross_kv=cross_kv)
    return norm(x, params["dec_final"], cfg.norm_eps), caches


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"])
    x, _ = decoder_forward(cfg, params, batch["tokens"], enc_out)
    return chunked_cross_entropy(x, params["embed"], batch["labels"],
                                 vocab_size=cfg.vocab_size,
                                 n_chunks=cfg.logit_chunk)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                device) -> Dict:
    dtype = cfg.jdtype
    self_shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    cross_shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)

    def one():
        return {"k": torch.zeros(self_shape, dtype=dtype, device=device),
                "v": torch.zeros(self_shape, dtype=dtype, device=device),
                "xk": torch.zeros(cross_shape, dtype=dtype, device=device),
                "xv": torch.zeros(cross_shape, dtype=dtype, device=device)}

    return {"dec": [one() for _ in range(cfg.n_layers)]}


def prefill(cfg: ModelConfig, params: Dict, frames: torch.Tensor,
            tokens: torch.Tensor, max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Encode the frames, fill every layer's cross K/V and the decoder's
    self cache; returns (last-token logits (B, Vp), caches)."""
    b, s = tokens.shape
    enc_out = encode(cfg, params, frames)
    caches = init_caches(cfg, b, max_seq or s, frames.shape[1],
                         tokens.device)
    for p, c in zip(params["dec_layers"], caches["dec"]):
        ck, cv = gqa_kv(enc_out, p["cross"], cfg, None)
        c["xk"].copy_(ck)
        c["xv"].copy_(cv)
    del enc_out
    x, caches = decoder_forward(cfg, params, tokens, None, caches=caches,
                                pos=0)
    return x[:, -1] @ params["embed"].T, caches


def decode_step(cfg: ModelConfig, params: Dict, caches: Dict,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    x, caches = decoder_forward(cfg, params, tokens, None, caches=caches,
                                pos=pos)
    return x[:, -1] @ params["embed"].T, caches
