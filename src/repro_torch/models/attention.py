"""Attention mixers: GQA and MLA (DeepSeek-V2), with three implementations.

Port of ``repro.models.attention``.  Layouts are the reference's: q (B,
Sq, H, hd), k/v (B, Skv, G, hd) with H = G * rep.

* ``einsum``  -- full (Sq x Skv) scores; the prefill branch repeats the
  GQA kv heads, the grouped branch attends without the repeat: decode
  (Sq == 1), and any Sq when the head count does not divide the mesh's
  ``model`` axis (``shardctx.axis_size``, 1 outside ``use_mesh``), as
  in the reference;
* ``chunked`` -- a loop over query chunks of ``cfg.attn_chunk``, each with
  masked full-length scores;
* ``flash``   -- the CUDA kernel through ``kernels.ops.flash_attention``;
  forward without a cache only, as in the reference; MLA refuses it.

KV caches are dicts of (B, Smax, G, hd) tensors (MLA: the latent ``ckv``
and ``krope``) updated IN PLACE at ``pos`` (the reference returns updated
copies; the port saves the memory).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.shardctx import axis_size
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (Gen, apply_rope, device_of, randn,
                                      rmsnorm, rope_tables)

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
    if sq > 1 and h % max(axis_size("model"), 1) == 0:
        # train/prefill with heads that divide the tensor-parallel size:
        # repeat the GQA kv heads to full H
        if g != h:
            k = k.repeat_interleave(h // g, dim=2)
            v = v.repeat_interleave(h // g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        s = torch.where(mask[None, None], s, NEG)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhv->bqhv", p, v)
        return o.reshape(b, sq, h, v.shape[-1])
    # decode, and heads that do not divide the model axis: grouped form,
    # no GQA repeat
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

def init_gqa(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim_
    s = d ** -0.5
    p = {
        "wq": randn(gen, (d, cfg.n_heads * hd), dtype, s),
        "wk": randn(gen, (d, cfg.n_kv_heads * hd), dtype, s),
        "wv": randn(gen, (d, cfg.n_kv_heads * hd), dtype, s),
        "wo": randn(gen, (cfg.n_heads * hd, d), dtype,
                    (cfg.n_heads * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["qnorm"] = torch.zeros((hd,), device=device_of(gen))
        p["knorm"] = torch.zeros((hd,), device=device_of(gen))
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


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV
# --------------------------------------------------------------------------

def init_mla(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    r = m.kv_lora_rank
    return {
        "wq": randn(gen, (d, h * (m.qk_nope_dim + m.qk_rope_dim)), dtype, s),
        "wdkv": randn(gen, (d, r), dtype, s),
        "wkrope": randn(gen, (d, m.qk_rope_dim), dtype, s),
        "wuk": randn(gen, (r, h * m.qk_nope_dim), dtype, r ** -0.5),
        "wuv": randn(gen, (r, h * m.v_head_dim), dtype, r ** -0.5),
        "wo": randn(gen, (h * m.v_head_dim, d), dtype,
                    (h * m.v_head_dim) ** -0.5),
    }


def mla_attention(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  cache: Optional[Dict] = None,
                  pos: Optional[int] = None,
                  absorbed: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """cache: {"ckv": (B, Smax, rank), "krope": (B, Smax, rope_dim)},
    written in place at ``pos``.

    The non-absorbed form up-projects the whole cached latent to per-head
    K/V.  ``absorbed=True`` folds W_uk into the query and W_uv into the
    output, so attention runs in the latent space: one kv head of width
    rank + rope; a decode step (S == 1) scores the latent and rope caches
    apart and adds them, reading the cache in place.

    ``attn_impl="flash"`` is refused: the kernel scales by its own head
    dim and needs v's head dim equal to q's, while MLA scales by
    (nope + rope) ** -0.5 and its v is narrower (the reference's flash
    branch fails on MLA's shapes).
    """
    if cfg.attn_impl == "flash":
        raise ValueError("MLA does not run on the flash kernel: it drops "
                         "MLA's scale and needs v's head dim equal to q's; "
                         "use attn_impl='chunked' or 'einsum'")
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = (x @ p["wq"]).reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    qn, qr = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    sin, cos = rope_tables(positions, m.qk_rope_dim, cfg.rope_theta)
    qr = apply_rope(qr, sin, cos)
    ckv = x @ p["wdkv"]                                   # (B, S, rank)
    kr = apply_rope((x @ p["wkrope"])[:, :, None, :], sin, cos)[:, :, 0, :]
    kv_len = None
    q_offset = None
    if cache is not None:
        cache["ckv"][:, pos:pos + s] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, pos:pos + s] = kr.to(cache["krope"].dtype)
        ckv, kr = cache["ckv"], cache["krope"]
        kv_len = pos + s
        q_offset = pos
    skv = ckv.shape[1]
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    ckv_c = ckv.to(x.dtype)
    kr_c = kr.to(x.dtype)
    if absorbed:
        wuk = p["wuk"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
        q_lat = torch.einsum("bqhn,rhn->bqhr", qn, wuk)
        if s == 1:
            # split-score decode: the latent and rope caches are scored
            # apart, so no (B, Smax, rank + rope) copy is made
            sc = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_c)
                  + torch.einsum("bqhn,bkn->bhqk", qr, kr_c)) * scale
            sc = sc.float()
            if kv_len is not None:
                kmask = torch.arange(skv, device=x.device) < kv_len
                sc = torch.where(kmask[None, None, None, :], sc, NEG)
            pr = torch.softmax(sc, dim=-1).to(x.dtype)
            o_lat = torch.einsum("bhqk,bkr->bqhr", pr, ckv_c)
        else:
            qt = torch.cat([q_lat, qr], dim=-1)           # (b,s,h,rank+rope)
            kt = torch.cat([ckv_c, kr_c], dim=-1)[:, :, None, :]
            vt = ckv_c[:, :, None, :]                     # (b,skv,1,rank)
            o_lat = attend(qt, kt, vt, cfg, causal=True, kv_len=kv_len,
                           scale=scale, q_offset=q_offset)
        wuv = p["wuv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        o = torch.einsum("bqhr,rhv->bqhv", o_lat, wuv)
    else:
        kn = (ckv_c @ p["wuk"]).reshape(b, skv, h, m.qk_nope_dim)
        kt = torch.cat([kn, kr_c[:, :, None, :].expand(
            b, skv, h, m.qk_rope_dim)], dim=-1)
        qt = torch.cat([qn, qr], dim=-1)
        v = (ckv_c @ p["wuv"]).reshape(b, skv, h, m.v_head_dim)
        o = attend(qt, kt, v, cfg, causal=True, kv_len=kv_len, scale=scale,
                   q_offset=q_offset)
    return o.reshape(b, s, h * m.v_head_dim) @ p["wo"], cache
