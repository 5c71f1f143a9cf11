"""Registry: --arch <id> lookup, assigned shapes, smoke-config reduction.

Port of ``repro.configs.registry``: the ten LM architectures, the four
shape cells and the reference's ``smoke_config`` rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (chameleon_34b, chatglm3_6b,
                                 deepseek_v2_lite_16b, grok_1_314b,
                                 jamba_v0_1_52b, llama3_2_1b, llama3_8b,
                                 mistral_large_123b, whisper_large_v3,
                                 xlstm_125m)
from repro_torch.configs.base import (EncDecCfg, MLACfg, ModelConfig,
                                      ShapeCfg)

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (deepseek_v2_lite_16b, grok_1_314b, whisper_large_v3,
              llama3_8b, llama3_2_1b, mistral_large_123b, chatglm3_6b,
              jamba_v0_1_52b, chameleon_34b, xlstm_125m)
}

SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}

# sub-quadratic decode state: the only archs that run long_500k
SUBQUADRATIC = {"jamba-v0.1-52b", "xlstm-125m"}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeCfg:
    return SHAPES[name]


def cell_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


def smoke_config(name: str, **overrides) -> ModelConfig:
    """Reduced same-family config (small width/depth/vocab, tiny expert
    count) that runs a serve step on the CPU in seconds.  The structure
    (MoE periods, MLA, mamba/attn interleave, enc-dec, xLSTM pattern,
    dense-first layers) is kept, so the smoke config runs the same code
    paths as the full config."""
    cfg = get_arch(name)
    kw = dict(
        n_layers=max(2 * cfg.layer_period, 2) + cfg.dense_first_n,
        d_model=128,
        n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        attn_chunk=64,
        logit_chunk=2,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=128, group_size=32)
    if cfg.mla is not None:
        kw["mla"] = MLACfg(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=16,
                           v_head_dim=32)
        kw["head_dim"] = 32        # nope + rope
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk=16)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecCfg(n_enc_layers=2, dec_ratio=4)
        kw["n_layers"] = 2
    if cfg.dense_first_n:
        kw["d_ff_dense"] = 256
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
