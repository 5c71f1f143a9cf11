"""whisper-large-v3 [audio] -- arXiv:2212.04356 (unverified tier).

Enc-dec, 32+32L d_model=1280 20H d_ff=5120 vocab=51866.  Conv frontend is a
stub: input_specs() provides precomputed frame embeddings (B, S, 1280).
"""
from repro_torch.configs.base import EncDecCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,               # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    rope="none",
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    encdec=EncDecCfg(n_enc_layers=32, dec_ratio=8),
    # 20 heads don't divide the 16-way TP axis -> scores stay head-
    # replicated; a smaller q-chunk bounds the transient instead.
    attn_chunk=128,
)
