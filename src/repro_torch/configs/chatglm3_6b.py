"""chatglm3-6b [dense] -- arXiv:2406.12793 (hf-verified tier).

2d RoPE (rotary on half the head dims), GQA kv=2.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="half",
    rope_theta=1e4,
    act="swiglu",
)
