"""Shared LM building blocks: norms, RoPE, MLPs, MoE, dynasparse linear,
CE.

Port of ``repro.models.layers``.  Function-style over plain dict params;
float32 accumulation in norms, softmax and cross entropy; params and
activations in the config dtype (bfloat16 by default).

Params are drawn by :func:`randn` from a ``torch.Generator`` on the
params' device; passing :data:`META` instead of a generator builds the
same tree on the meta device (shapes and dtypes, no storage).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.core import dynasparse
from repro_torch.core.perf_model import TPUCostModel

FFN_BLOCK = (256, 256, 256)
META = torch.device("meta")
Gen = Union[torch.Generator, torch.device]


def device_of(gen: Gen) -> torch.device:
    return gen if isinstance(gen, torch.device) else gen.device


def randn(gen: Gen, shape, dtype: torch.dtype, scale: float
          ) -> torch.Tensor:
    """``scale`` times a standard normal draw from ``gen`` (an empty
    tensor on the meta device when ``gen`` is :data:`META`, the only
    device passed in place of a generator)."""
    if isinstance(gen, torch.device):
        return torch.empty(shape, dtype=dtype, device=META)
    return torch.randn(shape, dtype=dtype, device=gen.device,
                       generator=gen) * scale


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
        h = _act(cfg, _linear(x, p["w1"], cfg)) * _linear(x, p["w3"], cfg)
    else:
        h = F.gelu(_linear(x, p["w1"], cfg), approximate="tanh")
    return _linear(h, p["w2"], cfg)


def init_mlp(gen: Gen, cfg: ModelConfig, d_ff: int,
             dtype: torch.dtype) -> Dict:
    d = cfg.d_model
    p = {"w1": randn(gen, (d, d_ff), dtype, d ** -0.5),
         "w2": randn(gen, (d_ff, d), dtype, d_ff ** -0.5)}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = randn(gen, (d, d_ff), dtype, d ** -0.5)
    return p


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return F.silu(h) if cfg.act == "swiglu" else F.gelu(h, approximate="tanh")


# --------------------------------------------------------------------------
# MoE: top-k router + capacity dispatch (Mesh-TF style) + shared experts.
# The expert products are batched matmuls over (experts, capacity slots),
# as the reference's einsums are; the shared experts are one dense MLP
# (through ``_linear``, so through the Dynasparse kernels under
# ``dynasparse_ffn``).
# --------------------------------------------------------------------------

def moe_capacity(m: MoECfg) -> int:
    return max(int(m.group_size * m.top_k * m.capacity_factor
                   / m.n_experts + 0.5), 1)


def moe_route(probs: torch.Tensor, top_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``probs`` along the last axis, ties to the lower index (as
    ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def moe_routing(xg: torch.Tensor, p: Dict, m: MoECfg, t: int) -> Dict:
    """Route the grouped tokens xg (g, gsz, D), of which the first ``t``
    are real: gate weights and experts of each (token, choice) (top-k,
    ties to the lower index), each choice's float32 cumsum position within
    its expert, ``keep`` (position below ``moe_capacity``), the slot
    (``cap``, the trash slot, where dropped), the one-hot choices and the
    router's probabilities."""
    g, gsz, _ = xg.shape
    logits = torch.einsum("gsd,de->gse", xg, p["router"].to(xg.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_w, gate_i = moe_route(probs, m.top_k)                 # (g, s, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(gate_i, m.n_experts).to(torch.bfloat16)
    if g * gsz > t:  # padded rows must not consume expert capacity
        valid = (torch.arange(g * gsz, device=xg.device) < t).reshape(g, gsz)
        onehot = onehot * valid[..., None, None].to(onehot.dtype)
    # position of each (token, choice) within its expert's capacity
    pos = torch.cumsum(onehot.reshape(g, gsz * m.top_k, m.n_experts)
                       .float(), dim=1)
    pos = pos.reshape(g, gsz, m.top_k, m.n_experts) * onehot - 1.0
    pos_k = pos.amax(dim=-1).to(torch.int64)                   # (g, s, k)
    cap = moe_capacity(m)
    keep = (pos_k >= 0) & (pos_k < cap)
    return {"gate_w": gate_w, "gate_i": gate_i, "pos": pos_k, "keep": keep,
            "slot": torch.where(keep, pos_k, cap), "onehot": onehot,
            "probs": probs}


def moe_ffn(x: torch.Tensor, p: Dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (out, aux_loss).  Tokens are cut into groups of
    ``group_size`` (the last one zero-padded; padded rows take no
    capacity) and routed by :func:`moe_routing`.  Experts read their slots
    by a slot-inverse gather; each token gathers its k outputs back and
    sums them weighted by the renormalised gates (dropped choices weigh
    0).  The aux loss is the Switch load-balance term.  Shared experts
    add one dense MLP of width ``n_shared * expert_d_ff``."""
    m = cfg.moe
    d = cfg.d_model
    lead = x.shape[:-1]
    t = math.prod(lead)
    xf = x.reshape(t, d)
    gsz = min(m.group_size, t)
    pad = (-t) % gsz
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    g = xf.shape[0] // gsz
    xg = xf.reshape(g, gsz, d)
    dev = x.device
    r = moe_routing(xg, p, m, t)
    gate_i, slot = r["gate_i"], r["slot"]
    cap = moe_capacity(m)

    # slot-inverse gather dispatch: slot_src[g, e, c] is the token in slot
    # c of expert e (gsz, a zero row, where the slot is empty); the trash
    # slot takes every dropped choice and is cut off
    gi = torch.arange(g, device=dev)[:, None]
    src = torch.arange(gsz, device=dev)[None, :, None].expand(gate_i.shape)
    slot_src = torch.full((g, m.n_experts, cap + 1), gsz, dtype=torch.int64,
                          device=dev)
    slot_src[gi[..., None].expand(gate_i.shape), gate_i, slot] = src
    slot_src = slot_src[..., :cap]
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    xe = xg_pad[gi, slot_src.reshape(g, m.n_experts * cap)]
    xe = xe.reshape(g, m.n_experts, cap, d).transpose(0, 1)
    xe = xe.reshape(m.n_experts, g * cap, d)
    if cfg.act in ("swiglu", "geglu"):
        h = _act(cfg, torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"])
    else:
        h = F.gelu(torch.bmm(xe, p["we1"]), approximate="tanh")
    ye = torch.bmm(h, p["we2"])
    # combine: gather each token's k expert outputs back, weight, sum
    ye_g = ye.reshape(m.n_experts, g, cap, d).transpose(0, 1)
    ye_g = ye_g.reshape(g, m.n_experts * cap, d)
    tok_idx = (gate_i * cap + torch.clamp(slot, max=cap - 1)).reshape(
        g, gsz * m.top_k)
    y_tok = ye_g[gi, tok_idx].reshape(g, gsz, m.top_k, d)
    w_tok = (r["gate_w"] * r["keep"]).to(x.dtype)
    out = torch.einsum("gsk,gskd->gsd", w_tok, y_tok)

    # load-balance aux loss (Switch): E * mean(frac_tokens_e * mean_prob_e);
    # frac is a bfloat16 mean (float32 sum), as the reference's jnp.mean
    onehot = r["onehot"]
    per_tok = onehot[..., 0, :] if m.top_k == 1 else onehot.sum(2) / m.top_k
    frac = (per_tok.float().sum((0, 1)) / (g * gsz)).to(torch.bfloat16)
    mean_prob = r["probs"].mean((0, 1))
    aux = m.n_experts * torch.sum(frac * mean_prob) * m.aux_loss_weight

    out = out.reshape(g * gsz, d)[:t].reshape(*lead, d)
    if m.n_shared:
        out = out + mlp(x, p["shared"], cfg)
    return out, aux


def init_moe(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    dff = m.expert_d_ff or cfg.d_ff
    e = m.n_experts
    p = {
        "router": randn(gen, (d, e), torch.float32, d ** -0.5),
        "we1": randn(gen, (e, d, dff), dtype, d ** -0.5),
        "we2": randn(gen, (e, dff, d), dtype, dff ** -0.5),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["we3"] = randn(gen, (e, d, dff), dtype, d ** -0.5)
    if m.n_shared:
        p["shared"] = init_mlp(gen, cfg, dff * m.n_shared, dtype)
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
