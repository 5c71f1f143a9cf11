"""chameleon-34b [vlm] -- arXiv:2405.09818 (unverified tier).

Early-fusion: VQ image tokens share the 65536 vocab with text, so the
modality frontend stub is the embedding table itself (token ids in, no
pixel path).  QK-norm per the paper's divergence fix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    rope="full",
    rope_theta=1e4,
    act="swiglu",
    qk_norm=True,
)
