"""Decoder-only LM assembly (the dense family).

Port of the dense decoder-only path of ``repro.models.transformer``.  The
reference scans over stacked per-period params; the port runs eagerly and
keeps one dict per layer (``params["layers"]``), which is the reference's
unrolled layout.  ``model_zoo.params_from_reference`` takes either of the
reference's layouts.  The reference's ``shard(...)`` constraints are the
identity on one device and are dropped; ``remat`` and ``scan_layers`` are
compile-time choices of the reference with no eager counterpart.

Caches: ``{"layers": [{"k": (B, Smax, G, hd), "v": ...}, ...]}``, updated
in place by ``forward``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import gqa_attention, init_gqa
from repro_torch.models.layers import (chunked_cross_entropy, init_mlp, mlp,
                                       norm)

NOT_PORTED = "not ported yet (ROADMAP queue 1: MoE/MLA/SSM/xLSTM/enc-dec)"


def check_dense(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is attention + dense FFN."""
    for what, unsupported in (
            ("MoE layers", cfg.moe is not None),
            ("MLA attention", cfg.mla is not None),
            ("mamba layers", cfg.mamba is not None or cfg.attn_period != 1),
            ("xLSTM layers", cfg.xlstm is not None),
            ("encoder-decoder models", cfg.encdec is not None),
            ("dense-first layers", cfg.dense_first_n != 0)):
        if unsupported:
            raise NotImplementedError(f"{cfg.name}: {what} are {NOT_PORTED}")


def _init_norm(cfg: ModelConfig, device) -> Dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), device=device),
                "bias": torch.zeros((cfg.d_model,), device=device)}
    return {"scale": torch.zeros((cfg.d_model,), device=device)}


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    return {"ln1": _init_norm(cfg, gen.device),
            "mix": init_gqa(gen, cfg, dtype),
            "ln2": _init_norm(cfg, gen.device),
            "ffn": init_mlp(gen, cfg, cfg.d_ff, dtype)}


def apply_block(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                positions: torch.Tensor, cache: Optional[Dict],
                pos: int) -> Tuple[torch.Tensor, Optional[Dict]]:
    h = norm(x, p["ln1"], cfg.norm_eps)
    out, cache = gqa_attention(h, p["mix"], cfg, positions=positions,
                               cache=cache, pos=pos)
    x = x + out
    x = x + mlp(norm(x, p["ln2"], cfg.norm_eps), p["ffn"], cfg)
    return x, cache


# --------------------------------------------------------------------------
# Parameters and caches
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    check_dense(cfg)
    dtype = cfg.jdtype
    kw = dict(dtype=dtype, device=gen.device, generator=gen)
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.padded_vocab, cfg.d_model), **kw) * 0.02,
        "final_norm": _init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((cfg.padded_vocab, cfg.d_model),
                                        **kw) * 0.02
    params["layers"] = [init_block(gen, cfg, dtype)
                        for _ in range(cfg.n_layers)]
    return params


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device) -> Dict:
    dtype = (getattr(torch, cfg.kv_cache_dtype) if cfg.kv_cache_dtype
             else cfg.jdtype)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {"layers": [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            caches: Optional[Dict] = None, pos: int = 0
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """tokens: (B, S) -> hidden (B, S, D), caches (updated in place), aux
    loss (zero for the dense family)."""
    _, s = tokens.shape
    x = params["embed"][tokens]
    positions = pos + torch.arange(s, device=tokens.device)
    layer_caches = (caches["layers"] if caches is not None
                    else [None] * len(params["layers"]))
    for p, c in zip(params["layers"], layer_caches):
        x, _ = apply_block(x, p, cfg, positions=positions, cache=c, pos=pos)
    x = norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux


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
