"""Decoder-only / hybrid LM assembly.

Port of ``repro.models.transformer``.  Heterogeneous stacks (Jamba's
mamba/attention interleave with its MoE period, xLSTM's mLSTM/sLSTM
pattern, DeepSeek's dense-first layers) follow ``cfg.layer_kind``: the
layer at scan index i has kind ``cfg.layer_kind(i % cfg.layer_period)``.
The reference scans over stacked per-period params; the port runs eagerly
and keeps one dict per layer (``params["dense_first"]`` and
``params["layers"]``), which is the reference's unrolled layout.
``model_zoo.params_from_reference`` takes either of the reference's
layouts.  The reference's ``shard(...)`` constraints are the identity on
one device and are dropped; ``remat`` and ``scan_layers`` are compile-time
choices of the reference with no eager counterpart.

Caches: ``{"dense_first": [...], "layers": [...]}``, one dict per layer
(attention k/v or the MLA latent, the mamba conv/ssm state, the mLSTM or
sLSTM state), updated in place by ``forward``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm, xlstm
from repro_torch.models.attention import (gqa_attention, init_gqa, init_mla,
                                          mla_attention)
from repro_torch.models.layers import (Gen, chunked_cross_entropy,
                                       device_of, init_mlp, init_moe, mlp,
                                       moe_ffn, norm, randn)

DENSE_FIRST = {"mixer": "attn", "ffn": "dense_first"}


def _init_norm(cfg: ModelConfig, device) -> Dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), device=device),
                "bias": torch.zeros((cfg.d_model,), device=device)}
    return {"scale": torch.zeros((cfg.d_model,), device=device)}


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of every layer of the scanned region, in order."""
    return [cfg.layer_kind(i % cfg.layer_period)
            for i in range(cfg.n_scan_layers)]


def init_block(gen: Gen, cfg: ModelConfig, kind: Dict, dtype) -> Dict:
    dev = device_of(gen)
    p: Dict[str, Any] = {"ln1": _init_norm(cfg, dev)}
    mixer = kind["mixer"]
    if mixer == "attn":
        p["mix"] = (init_mla(gen, cfg, dtype) if cfg.mla is not None
                    else init_gqa(gen, cfg, dtype))
    elif mixer == "mamba":
        p["mix"] = ssm.init_mamba(gen, cfg, dtype)
    elif mixer == "mlstm":
        p["mix"] = xlstm.init_mlstm(gen, cfg, dtype)
    elif mixer == "slstm":
        p["mix"] = xlstm.init_slstm(gen, cfg, dtype)
    else:
        raise ValueError(mixer)
    ffn = kind["ffn"]
    if ffn != "none":
        p["ln2"] = _init_norm(cfg, dev)
        if ffn == "moe":
            p["ffn"] = init_moe(gen, cfg, dtype)
        elif ffn == "dense_first":
            p["ffn"] = init_mlp(gen, cfg, cfg.d_ff_dense or cfg.d_ff, dtype)
        else:
            p["ffn"] = init_mlp(gen, cfg, cfg.d_ff, dtype)
    return p


def apply_block(x: torch.Tensor, p: Dict, cfg: ModelConfig, kind: Dict, *,
                positions: torch.Tensor, cache: Optional[Dict], pos: int
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, cache, aux_loss); the cache is updated in place."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm(x, p["ln1"], cfg.norm_eps)
    c = cache if cache else None
    mixer = kind["mixer"]
    if mixer == "attn":
        if cfg.mla is not None:
            out, c = mla_attention(h, p["mix"], cfg, positions=positions,
                                   cache=c, pos=pos,
                                   absorbed=cfg.mla_absorbed)
        else:
            out, c = gqa_attention(h, p["mix"], cfg, positions=positions,
                                   cache=c, pos=pos)
    elif mixer == "mamba":
        out, c = ssm.mamba_mixer(h, p["mix"], cfg, cache=c)
    elif mixer == "mlstm":
        out, c = xlstm.mlstm_mixer(h, p["mix"], cfg, cache=c)
    elif mixer == "slstm":
        out, c = xlstm.slstm_mixer(h, p["mix"], cfg, cache=c)
    else:
        raise ValueError(mixer)
    x = x + out
    if kind["ffn"] != "none":
        h2 = norm(x, p["ln2"], cfg.norm_eps)
        if kind["ffn"] == "moe":
            f, aux = moe_ffn(h2, p["ffn"], cfg)
        else:
            f = mlp(h2, p["ffn"], cfg)
        x = x + f
    return x, c, aux


# --------------------------------------------------------------------------
# Parameters and caches
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: Gen) -> Dict:
    """Random params on ``gen``'s device, drawn from ``gen`` (on the meta
    device when ``gen`` is ``layers.META``)."""
    dtype = cfg.jdtype
    dev = device_of(gen)
    params: Dict[str, Any] = {
        "embed": randn(gen, (cfg.padded_vocab, cfg.d_model), dtype, 0.02),
        "final_norm": _init_norm(cfg, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = randn(gen, (cfg.padded_vocab, cfg.d_model),
                                  dtype, 0.02)
    if cfg.dense_first_n:
        params["dense_first"] = [init_block(gen, cfg, DENSE_FIRST, dtype)
                                 for _ in range(cfg.dense_first_n)]
    params["layers"] = [init_block(gen, cfg, kind, dtype)
                        for kind in layer_kinds(cfg)]
    return params


def _cache_for_kind(cfg: ModelConfig, kind: Dict, batch: int, max_seq: int,
                    device) -> Dict:
    dtype = cfg.jdtype
    kv_dtype = (getattr(torch, cfg.kv_cache_dtype) if cfg.kv_cache_dtype
                else dtype)

    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    mixer = kind["mixer"]
    if mixer == "attn":
        if cfg.mla is not None:
            m = cfg.mla
            return {"ckv": zeros((batch, max_seq, m.kv_lora_rank), kv_dtype),
                    "krope": zeros((batch, max_seq, m.qk_rope_dim),
                                   kv_dtype)}
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": zeros(shape, kv_dtype), "v": zeros(shape, kv_dtype)}
    if mixer == "mamba":
        m = cfg.mamba
        di = m.d_inner(cfg.d_model)
        return {"conv": zeros((batch, m.d_conv - 1, di), dtype),
                "ssm": zeros((batch, di, m.d_state))}
    if mixer == "mlstm":
        h = cfg.n_heads
        hd = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor) // h
        return {"c": zeros((batch, h, hd, hd)), "n": zeros((batch, h, hd)),
                "m": full((batch, h), -10.0)}
    if mixer == "slstm":
        d = cfg.d_model
        return {"c": zeros((batch, d)), "n": full((batch, d), 1e-6),
                "h": zeros((batch, d)), "m": full((batch, d), -10.0)}
    raise ValueError(mixer)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device) -> Dict:
    out: Dict[str, Any] = {}
    if cfg.dense_first_n:
        out["dense_first"] = [
            _cache_for_kind(cfg, DENSE_FIRST, batch, max_seq, device)
            for _ in range(cfg.dense_first_n)]
    out["layers"] = [_cache_for_kind(cfg, kind, batch, max_seq, device)
                     for kind in layer_kinds(cfg)]
    return out


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            caches: Optional[Dict] = None, pos: int = 0
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """tokens: (B, S) -> hidden (B, S, D), caches (updated in place), the
    summed aux loss of every MoE layer."""
    _, s = tokens.shape
    x = params["embed"][tokens]
    positions = pos + torch.arange(s, device=tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stacks = [("dense_first", [DENSE_FIRST] * cfg.dense_first_n),
              ("layers", layer_kinds(cfg))]
    for key, kinds in stacks:
        if not kinds:
            continue
        layer_caches = (caches[key] if caches is not None
                        else [None] * len(kinds))
        for p, c, kind in zip(params[key], layer_caches, kinds):
            x, _, aux = apply_block(x, p, cfg, kind, positions=positions,
                                    cache=c, pos=pos)
            aux_total = aux_total + aux
    x = norm(x, params["final_norm"], cfg.norm_eps)
    return x, caches, aux_total


def lm_head(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    x, _, aux = forward(cfg, params, batch["tokens"])
    ce = chunked_cross_entropy(x, lm_head(cfg, params), batch["labels"],
                               vocab_size=cfg.vocab_size,
                               n_chunks=cfg.logit_chunk)
    return ce + aux


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Returns (last-token logits (B, Vp), caches filled to len(tokens))."""
    b, s = tokens.shape
    caches = init_caches(cfg, b, max_seq or s, tokens.device)
    x, caches, _ = forward(cfg, params, tokens, caches=caches, pos=0)
    return x[:, -1] @ lm_head(cfg, params).T, caches


def decode_step(cfg: ModelConfig, params: Dict, caches: Dict,
                tokens: torch.Tensor, pos: int
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1); pos: the write offset.  One serving step."""
    x, caches, _ = forward(cfg, params, tokens, caches=caches, pos=pos)
    return x[:, -1] @ lm_head(cfg, params).T, caches
