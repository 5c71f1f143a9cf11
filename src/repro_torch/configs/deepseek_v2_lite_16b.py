"""deepseek-v2-lite-16b [moe] -- arXiv:2405.04434 (hf-verified tier).

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MLA kv_lora=512,
2 shared + 64 routed experts top-6.  The assignment header says "64e top-6"
and the detail note "2 shared+160 routed"; we follow the HF DeepSeek-V2-Lite
card: 64 routed + 2 shared, top-6, first layer dense d_ff=10944 (deviation
recorded in DESIGN.md section 5).
"""
from repro_torch.configs.base import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,              # 128 nope + 64 rope
    d_ff=1408,
    vocab_size=102400,
    rope="full",
    rope_theta=1e4,
    act="swiglu",
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
               period=1),
    mla=MLACfg(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
               v_head_dim=128),
    dense_first_n=1,
    d_ff_dense=10944,
)
