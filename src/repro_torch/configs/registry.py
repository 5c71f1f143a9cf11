"""Registry: --arch <id> lookup, assigned shapes, smoke-config reduction.

Port of ``repro.configs.registry`` for the two dense decoder-only
architectures the port runs (``llama3.2-1b``, ``llama3-8b``).  The other
eight architectures of the reference wait for the port of their layer
kinds (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import llama3_2_1b, llama3_8b
from repro_torch.configs.base import ModelConfig, ShapeCfg

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG for c in (llama3_8b, llama3_2_1b)
}

SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str, **overrides) -> ModelConfig:
    """Reduced same-family config (small width/depth/vocab), equal to the
    reference's ``smoke_config`` for the dense archs: runs a full serve
    step on the CPU in seconds."""
    cfg = get_arch(name)
    kw = dict(
        n_layers=max(2 * cfg.layer_period, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        attn_chunk=64,
        logit_chunk=2,
    )
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
