"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) + sLSTM.

Port of ``repro.models.xlstm``.

mLSTM: per head a (hd x hd) matrix memory C_t with exponential input gate
and forget gate.  The parallel form is attention-like with a decay mask
D[t, s] = exp(F_t - F_s + i_s - m_t), stabilised by the running max m,
and is chunked over queries; prefill rebuilds the recurrent state from
the full pass, and decode is the exact recurrence over (C, n, m).

sLSTM: scalar memory with a per-head block-diagonal recurrence, run step
by step over time.  Under :func:`recurrence_counted_once` (the dry run's
counting on the meta device) the loop runs its first step only and that
step's output stands for every step: the reference's counts come from
XLA's cost analysis, which counts a scan's body once.

Recurrent states are written back into the cache dicts given, in place.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Gen, device_of, randn, rmsnorm


_ONE_STEP = contextvars.ContextVar("slstm_one_step", default=False)


@contextlib.contextmanager
def recurrence_counted_once():
    """Within the block, the sLSTM time loop runs one step and repeats its
    output over the sequence: the shapes, and the counts of a scan body
    once, of the reference's cost analysis.  Not the model's values."""
    token = _ONE_STEP.set(True)
    try:
        yield
    finally:
        _ONE_STEP.reset(token)


def _write_back(cache: Dict, new: Dict) -> None:
    for k, v in new.items():
        cache[k].copy_(v)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    d = cfg.d_model
    di = int(d * cfg.xlstm.mlstm_proj_factor)
    h = cfg.n_heads
    s, si = d ** -0.5, di ** -0.5
    dev = device_of(gen)
    return {
        "up": randn(gen, (d, 2 * di), dtype, s),
        "wq": randn(gen, (di, di), dtype, si),
        "wk": randn(gen, (di, di), dtype, si),
        "wv": randn(gen, (di, di), dtype, si),
        "wi": randn(gen, (di, h), dtype, si),
        "wf": randn(gen, (di, h), dtype, si),
        "f_bias": torch.full((h,), 3.0, device=dev),  # forget gate open
        "onorm": torch.zeros((di,), device=dev),
        "down": randn(gen, (di, d), dtype, si),
    }


def _mlstm_parallel(q, k, v, ig, fg, chunk: int) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) float32; ig/fg: (B, S, H) float32 log-gates.
    Returns (B, S, H, hd).  Quadratic stabilised form over query chunks
    (the largest divisor of S not above ``chunk``), so only a (B, c, S, H)
    decay mask exists at a time."""
    b, s, h, hd = q.shape
    fcum = torch.cumsum(F.logsigmoid(fg), dim=1)           # F_t
    chunk = max(1, min(chunk, s))
    while s % chunk:
        chunk -= 1
    spos = torch.arange(s, device=q.device)
    outs = []
    for off in range(0, s, chunk):
        qc, fc = q[:, off:off + chunk], fcum[:, off:off + chunk]
        # log D[t, s'] = F_t - F_{s'} + i_{s'} for s' <= t
        logd = fc[:, :, None] - fcum[:, None, :] + ig[:, None, :, :]
        causal = (off + torch.arange(chunk, device=q.device))[:, None] \
            >= spos[None, :]
        logd = torch.where(causal[None, :, :, None], logd, -torch.inf)
        m = logd.amax(dim=2, keepdim=True)                  # (B,c,1,H)
        dmat = torch.exp(logd - m)
        scores = torch.einsum("bthd,bshd->btsh", qc, k) * (hd ** -0.5)
        w = scores * dmat
        norm = torch.maximum(torch.abs(w.sum(dim=2)), torch.exp(-m[:, :, 0]))
        outs.append(torch.einsum("btsh,bshd->bthd", w, v) / norm[..., None])
    return torch.cat(outs, dim=1)


def mlstm_mixer(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """cache: {"c": (B,H,hd,hd), "n": (B,H,hd), "m": (B,H)} float32."""
    b, s, d = x.shape
    di = int(d * cfg.xlstm.mlstm_proj_factor)
    h = cfg.n_heads
    hd = di // h
    up = x @ p["up"]
    xm, z = up[..., :di], up[..., di:]
    q = (xm @ p["wq"]).reshape(b, s, h, hd).float()
    k = (xm @ p["wk"]).reshape(b, s, h, hd).float()
    v = (xm @ p["wv"]).reshape(b, s, h, hd).float()
    ig = (xm @ p["wi"]).float()                             # (B,S,H) log
    fg = (xm @ p["wf"]).float() + p["f_bias"]
    ks = k * (hd ** -0.5)

    if s == 1 and cache is not None:
        # exact recurrent step
        c0, n0, m0 = (cache[n].float() for n in ("c", "n", "m"))
        logf = F.logsigmoid(fg[:, 0])                       # (B,H)
        i0 = ig[:, 0]
        m1 = torch.maximum(logf + m0, i0)
        fdec = torch.exp(logf + m0 - m1)[..., None]
        iinc = torch.exp(i0 - m1)[..., None]
        kk = ks[:, 0]                                       # (B,H,hd)
        c1 = fdec[..., None] * c0 + iinc[..., None] * torch.einsum(
            "bhd,bhe->bhde", kk, v[:, 0])
        n1 = fdec * n0 + iinc * kk
        hq = q[:, 0]                                        # (B,H,hd)
        num = torch.einsum("bhd,bhde->bhe", hq, c1)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", hq, n1)),
                            torch.exp(-m1))
        o = (num / den[..., None])[:, None]                 # (B,1,H,hd)
        _write_back(cache, {"c": c1, "n": n1, "m": m1})
    else:
        o = _mlstm_parallel(q, k, v, ig, fg, cfg.xlstm.chunk)
        if cache is not None:
            # rebuild the recurrent state from the full pass (prefill)
            fcum = torch.cumsum(F.logsigmoid(fg), dim=1)
            w_s = fcum[:, -1:, :] - fcum + ig               # (B,S,H)
            m1 = w_s.amax(dim=1)                            # (B,H)
            gam = torch.exp(w_s - m1[:, None])
            c1 = torch.einsum("bsh,bshd,bshe->bhde", gam, ks, v)
            n1 = torch.einsum("bsh,bshd->bhd", gam, ks)
            _write_back(cache, {"c": c1, "n": n1, "m": m1})
    o = o.to(x.dtype).reshape(b, s, di)
    o = rmsnorm(o, p["onorm"], cfg.norm_eps)
    return (o * F.silu(z)) @ p["down"], cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def init_slstm(gen: Gen, cfg: ModelConfig, dtype: torch.dtype) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dff = int(d * cfg.xlstm.slstm_proj_factor)
    dev = device_of(gen)
    return {
        "wx": randn(gen, (d, 4 * d), dtype, d ** -0.5),       # i, f, z, o
        "wr": randn(gen, (4, h, dh, dh), dtype, dh ** -0.5),
        "bias": torch.zeros((4, d), device=dev),
        "f_bias": torch.full((d,), 3.0, device=dev),
        "onorm": torch.zeros((d,), device=dev),
        "w1": randn(gen, (d, dff), dtype, d ** -0.5),
        "w2": randn(gen, (dff, d), dtype, dff ** -0.5),
    }


def slstm_mixer(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Step by step over time.  cache: {"c","n","h","m": (B, D)} float32
    states."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    gates_x = (x @ p["wx"]).float().reshape(b, s, 4, d) + p["bias"]
    gates_x[:, :, 1] += p["f_bias"]
    wr = p["wr"].float()
    if cache is not None:
        st = {k: v.float() for k, v in cache.items()}
    else:
        zero = torch.zeros((b, d), device=x.device)
        st = {"c": zero, "n": zero + 1e-6, "h": zero, "m": zero - 10.0}
    hs = []
    steps = 1 if _ONE_STEP.get() else s
    for t in range(steps):
        rec = torch.einsum("ghde,bhd->gbhe", wr, st["h"].reshape(b, h, dh))
        rec = rec.permute(1, 0, 2, 3).reshape(b, 4, d)
        gi, gf, gz, go = (gates_x[:, t] + rec).unbind(1)
        logf = F.logsigmoid(gf)
        m1 = torch.maximum(logf + st["m"], gi)
        i_ = torch.exp(gi - m1)
        f_ = torch.exp(logf + st["m"] - m1)
        c1 = f_ * st["c"] + i_ * torch.tanh(gz)
        n1 = f_ * st["n"] + i_
        h1 = torch.sigmoid(go) * c1 / torch.clamp(n1, min=1e-6)
        st = {"c": c1, "n": n1, "h": h1, "m": m1}
        hs.append(h1)
    y = torch.stack(hs, dim=1)
    if steps < s:
        y = torch.cat([y, hs[-1][:, None].expand(b, s - steps, d)], dim=1)
    y = y.to(x.dtype)                                       # (B,S,D)
    y = rmsnorm(y, p["onorm"], cfg.norm_eps)
    y = F.gelu(y @ p["w1"], approximate="tanh") @ p["w2"]
    if cache is not None:
        _write_back(cache, st)
    return y, cache
