"""Attention mixer: GQA with three implementations.

Port of the GQA half of ``repro.models.attention`` (MLA waits, ROADMAP
queue 1).  Layouts are the reference's: q (B, Sq, H, hd), k/v (B, Skv, G,
hd) with H = G * rep.

* ``einsum``  -- full (Sq x Skv) scores; the prefill branch repeats the
  GQA kv heads, the decode branch (Sq == 1) attends grouped;
* ``chunked`` -- a loop over query chunks of ``cfg.attn_chunk``, each with
  masked full-length scores;
* ``flash``   -- the CUDA kernel through ``kernels.ops.flash_attention``;
  forward without a cache only, as in the reference.

KV caches are dicts of (B, Smax, G, hd) tensors updated IN PLACE at
``pos`` (the reference returns updated copies; the port saves the memory).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rmsnorm, rope_tables

NEG = -1e30


def _rope_fraction(cfg: ModelConfig) -> float:
    return {"full": 1.0, "half": 0.5, "none": 0.0}[cfg.rope]


# --------------------------------------------------------------------------
# score/attend implementations
# --------------------------------------------------------------------------

def _attend_einsum(q, k, v, *, causal: bool, kv_len: Optional[int],
                   scale: float, q_offset: int) -> torch.Tensor:
    b, sq, h, hd = q.shape
    g = k.shape[2]
    skv = k.shape[1]
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        mask = kpos[None, :] <= qpos
    if kv_len is not None:
        mask = mask & (kpos[None, :] < kv_len)
    if sq > 1:
        # prefill: repeat the GQA kv heads to full H
        if g != h:
            k = k.repeat_interleave(h // g, dim=2)
            v = v.repeat_interleave(h // g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        s = torch.where(mask[None, None], s, NEG)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhv->bqhv", p, v)
        return o.reshape(b, sq, h, v.shape[-1])
    # decode: grouped form, no GQA repeat
    qg = q.reshape(b, sq, g, h // g, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg, k).float() * scale
    s = torch.where(mask[None, None, None], s, NEG)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bgrqk,bkgv->bqgrv", p, v)
    return o.reshape(b, sq, h, v.shape[-1])


def _attend_chunked(q, k, v, *, causal: bool, kv_len, scale: float,
                    chunk: int, q_offset: int) -> torch.Tensor:
    sq = q.shape[1]
    chunk = max(1, min(chunk, sq))
    while sq % chunk:
        chunk -= 1
    outs = [_attend_einsum(q[:, off:off + chunk], k, v, causal=causal,
                           kv_len=kv_len, scale=scale,
                           q_offset=q_offset + off)
            for off in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def attend(q, k, v, cfg: ModelConfig, *, causal: bool = True,
           kv_len: Optional[int] = None, scale: Optional[float] = None,
           q_offset: Optional[int] = None) -> torch.Tensor:
    """q_offset: position of q[0] in the kv sequence (default: end-aligned
    for no cache, i.e. skv - sq)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q_offset is None:
        q_offset = k.shape[1] - q.shape[1]
    if cfg.attn_impl == "einsum" or q.shape[1] == 1:
        return _attend_einsum(q, k, v, causal=causal, kv_len=kv_len,
                              scale=scale, q_offset=q_offset)
    if cfg.attn_impl == "chunked":
        return _attend_chunked(q, k, v, causal=causal, kv_len=kv_len,
                               scale=scale, chunk=cfg.attn_chunk,
                               q_offset=q_offset)
    if cfg.attn_impl == "flash":
        if kv_len is not None:
            raise ValueError("flash path is for train/prefill without a "
                             "cache (kv_len must be None, as in the "
                             "reference)")
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal)
        return o.transpose(1, 2)
    raise ValueError(cfg.attn_impl)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype
             ) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim_
    kw = dict(dtype=dtype, device=gen.device, generator=gen)
    s = d ** -0.5
    p = {
        "wq": torch.randn((d, cfg.n_heads * hd), **kw) * s,
        "wk": torch.randn((d, cfg.n_kv_heads * hd), **kw) * s,
        "wv": torch.randn((d, cfg.n_kv_heads * hd), **kw) * s,
        "wo": torch.randn((cfg.n_heads * hd, d), **kw)
        * (cfg.n_heads * hd) ** -0.5,
    }
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
        p["knorm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
    return p


def gqa_kv(x: torch.Tensor, p: Dict, cfg: ModelConfig,
           positions: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project K/V: (B, S, G, hd) each, K rotated."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["knorm"], cfg.norm_eps)
    if positions is not None and cfg.rope != "none":
        sin, cos = rope_tables(positions, int(hd * _rope_fraction(cfg)),
                               cfg.rope_theta)
        k = apply_rope(k, sin, cos, _rope_fraction(cfg))
    return k, v


def gqa_attention(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  pos: Optional[int] = None,
                  causal: bool = True,
                  kv: Optional[Tuple] = None,
                  kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self attention (kv=None) or cross attention (kv precomputed).

    cache: {"k": (B, Smax, G, hd), "v": ...}, written in place at
    ``pos``; the keys attended are then the whole cache, masked to
    ``pos + S``.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qnorm"], cfg.norm_eps)
    if cfg.rope != "none" and positions is not None:
        sin, cos = rope_tables(positions, int(hd * _rope_fraction(cfg)),
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos, _rope_fraction(cfg))
    q_offset = None
    if kv is None:
        k, v = gqa_kv(x, p, cfg, positions)
        if cache is not None:
            cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
            cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
            kv_len = pos + s
            q_offset = pos
    else:
        k, v = kv
    o = attend(q, k.to(q.dtype), v.to(q.dtype), cfg, causal=causal,
               kv_len=kv_len, q_offset=q_offset)
    return o.reshape(b, s, cfg.n_heads * hd) @ p["wo"], cache
