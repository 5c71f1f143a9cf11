"""Mamba (S6) mixer for the Jamba hybrid architecture.

Port of ``repro.models.ssm``.  Selective state space:
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t + D x_t, with
input-dependent (dt, B, C).

Prefill runs a CHUNKED scan: the sequence is cut into chunks (the largest
divisor of S not above ``mamba.chunk``), each discretised on its own so
only one (B, chunk, d_inner, d_state) block exists at a time; within a
chunk the linear recurrence is a log-depth (Hillis-Steele) scan, and the
chunks are stitched by carrying the state.  Decode is the exact
single-step recurrence over a (conv window, ssm state) cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Gen, device_of, randn


def init_mamba(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    m = cfg.mamba
    d = cfg.d_model
    di = m.d_inner(d)
    dr = m.dt_rank(d)
    dev = device_of(gen)
    return {
        "in_proj": randn(gen, (d, 2 * di), dtype, d ** -0.5),
        "conv_w": randn(gen, (m.d_conv, di), dtype, 0.3),
        "x_proj": randn(gen, (di, dr + 2 * m.d_state), dtype, di ** -0.5),
        "dt_proj": randn(gen, (dr, di), dtype, dr ** -0.5),
        "dt_bias": torch.zeros((di,), device=dev),
        "a_log": torch.log(torch.arange(1, m.d_state + 1, dtype=torch.float32,
                                        device=dev)).expand(di, m.d_state)
        .contiguous(),
        "d_skip": torch.ones((di,), device=dev),
        "out_proj": randn(gen, (di, d), dtype, di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq.  x: (B, S, di); w: (K, di).
    state: (B, K-1, di) left context.  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None, :]
    return y, (xp[:, -(k - 1):] if k > 1 else state)


def _ssm_chunk(a: torch.Tensor, bu: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk linear recurrence h_t = a_t h_{t-1} + bu_t, as a
    log-depth inclusive scan over the pairs (a, bu).

    a, bu: (B, C, di, ds) float32; h0: (B, di, ds).  Returns (h for every
    step, the last h)."""
    bu = bu.clone()
    bu[:, 0] += a[:, 0] * h0            # fold the incoming state in
    c = a.shape[1]
    off = 1
    while off < c:
        # (a, b)[t] <- (a[t] a[t-off], a[t] b[t-off] + b[t]) for t >= off
        a_new = a.clone()
        a_new[:, off:] = a[:, off:] * a[:, :-off]
        b_new = bu.clone()
        b_new[:, off:] = a[:, off:] * bu[:, :-off] + bu[:, off:]
        a, bu = a_new, b_new
        off *= 2
    return bu, bu[:, -1]


def mamba_mixer(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, D).  cache: {"conv": (B, K-1, di), "ssm": (B, di, ds)
    float32}; the new state is written back into the same tensors (and
    the dict is returned)."""
    m = cfg.mamba
    b, s, d = x.shape
    di = m.d_inner(d)
    dr = m.dt_rank(d)
    xz = x @ p["in_proj"]
    xin, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin)
    dbc = xin @ p["x_proj"]
    # softplus as jax.nn.softplus: logaddexp(x, 0), with no linear branch
    dt_in = dbc[..., :dr] @ p["dt_proj"] + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in)).float()
    bmat = dbc[..., dr:dr + m.d_state].float()                  # (B,S,ds)
    cmat = dbc[..., dr + m.d_state:].float()                    # (B,S,ds)
    a = -torch.exp(p["a_log"])                                  # (di, ds)
    ux = dt * xin.float()                                       # (B,S,di)

    h0 = (cache["ssm"].float() if cache is not None
          else torch.zeros((b, di, m.d_state), device=x.device))
    if s == 1:  # decode: exact single step
        da = torch.exp(dt[:, 0, :, None] * a[None])
        dbu = ux[:, 0, :, None] * bmat[:, 0, None, :]
        h_last = da * h0 + dbu
        y = torch.einsum("bds,bs->bd", h_last, cmat[:, 0])[:, None, :]
    else:
        chunk = max(1, min(m.chunk, s))
        while s % chunk:
            chunk -= 1
        ys = []
        h_last = h0
        for c0 in range(0, s, chunk):
            sl = slice(c0, c0 + chunk)
            a_i = torch.exp(dt[:, sl, :, None] * a[None, None])
            bu_i = ux[:, sl, :, None] * bmat[:, sl, None, :]
            h_all, h_last = _ssm_chunk(a_i, bu_i, h_last)
            ys.append(torch.einsum("bcds,bcs->bcd", h_all, cmat[:, sl]))
        y = torch.cat(ys, dim=1)
    y = y + xin.float() * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h_last)
    return out, cache
