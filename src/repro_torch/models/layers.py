"""Shared LM building blocks: norms, RoPE, MLPs, dynasparse linear, CE.

Port of the dense half of ``repro.models.layers`` (MoE waits, ROADMAP
queue 1).  Function-style over plain dict params; float32 accumulation in
norms, softmax and cross entropy; params and activations in the config
dtype (bfloat16 by default).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dynasparse
from repro_torch.core.perf_model import TPUCostModel

FFN_BLOCK = (256, 256, 256)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm with a zero-centred gain: ``y * (1 + scale)``."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> sin/cos tables (..., dim//2) in float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (S, rot/2).  Rotates the first
    ``fraction`` of head dims pairwise-interleaved (dims 2i and 2i+1)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    xf = xr.float().reshape(*xr.shape[:-1], rot // 2, 2)
    s = sin[..., None, : rot // 2]
    c = cos[..., None, : rot // 2]
    r0 = xf[..., 0] * c - xf[..., 1] * s
    r1 = xf[..., 1] * c + xf[..., 0] * s
    out = torch.stack([r0, r1], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# --------------------------------------------------------------------------
# Dense FFN (+ dynasparse-dispatched variant)
# --------------------------------------------------------------------------

def _linear(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The Update-kernel analogue in the LM.  With ``cfg.dynasparse_ffn``
    the product runs through the Dynasparse executor (profile both
    operands, plan every (256, 256, 256) block step with the reference's
    TPU cost model, one ``dispatch`` launch), so pruned weights and sparse
    activations get per-block primitive dispatch; otherwise a plain
    ``x @ w``."""
    if cfg.dynasparse_ffn:
        x2 = x.reshape(-1, x.shape[-1])
        res = dynasparse.dynasparse_matmul(x2, w, strategy="dynamic",
                                           block=FFN_BLOCK,
                                           cost_model=TPUCostModel())
        return res.out.reshape(*x.shape[:-1], w.shape[-1])
    return x @ w


def mlp(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act in ("swiglu", "geglu"):
        h = _linear(x, p["w1"], cfg)
        h = (F.silu(h) if cfg.act == "swiglu"
             else F.gelu(h, approximate="tanh"))
        h = h * _linear(x, p["w3"], cfg)
    else:
        h = F.gelu(_linear(x, p["w1"], cfg), approximate="tanh")
    return _linear(h, p["w2"], cfg)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
             dtype: torch.dtype) -> Dict:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=gen.device, generator=gen)
    p = {"w1": torch.randn((d, d_ff), **kw) * d ** -0.5,
         "w2": torch.randn((d_ff, d), **kw) * d_ff ** -0.5}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = torch.randn((d, d_ff), **kw) * d ** -0.5
    return p


# --------------------------------------------------------------------------
# Chunked cross entropy (big-vocab memory control)
# --------------------------------------------------------------------------

def chunked_cross_entropy(x: torch.Tensor, emb: torch.Tensor,
                          labels: torch.Tensor, *, vocab_size: int,
                          n_chunks: int = 8) -> torch.Tensor:
    """Mean CE of logits = x @ emb.T, computed ``n_chunks`` sequence
    chunks at a time so only one chunk's (B, S/n, Vp) float32 logits
    exist.  x: (B, S, D); emb: (Vp, D); labels: (B, S) in [0,
    vocab_size).  Padded vocab rows are masked out."""
    b, s, _ = x.shape
    n_chunks = max(1, min(n_chunks, s))
    while s % n_chunks:
        n_chunks -= 1
    step = s // n_chunks
    vmask = torch.arange(emb.shape[0], device=x.device) < vocab_size
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        xc = x[:, c * step:(c + 1) * step]
        yc = labels[:, c * step:(c + 1) * step]
        logits = (xc @ emb.T).float()
        logits = torch.where(vmask, logits, -1e30)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (b * s)
