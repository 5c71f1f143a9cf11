"""grok-1-314b [moe] -- hf:xai-org/grok-1 (unverified tier).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, 8 experts top-2.
bf16 optimizer state (see DESIGN.md memory budget: f32 m/v would not fit
256 chips at this parameter count).
"""
from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope="full",
    rope_theta=1e4,
    act="geglu",
    moe=MoECfg(n_experts=8, top_k=2, expert_d_ff=32768, period=1),
    opt_state_dtype="bfloat16",
)
