"""mistral-large-123b [dense] -- hf:mistralai/Mistral-Large-Instruct-2407
(unverified tier)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope="full",
    rope_theta=1e6,
    act="swiglu",
    opt_state_dtype="bfloat16",
)
