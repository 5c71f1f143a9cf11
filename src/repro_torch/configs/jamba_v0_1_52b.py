"""jamba-v0.1-52b [hybrid] -- arXiv:2403.19887 (hf-verified tier).

Mamba + attention at 1:7 (one attention layer per 8, at in-period index 3),
MoE every 2nd layer: 16 experts top-2.  Sub-quadratic decode state =>
long_500k RUNS for this arch.
"""
from repro_torch.configs.base import MambaCfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope="none",               # jamba uses no positional encoding
    act="swiglu",
    moe=MoECfg(n_experts=16, top_k=2, expert_d_ff=14336, period=2),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, chunk=64),
    attn_period=8,
    attn_at=3,
)
