"""xlstm-125m [ssm] -- arXiv:2405.04517 (unverified tier).

12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry their own
projections): mLSTM blocks with one sLSTM per 4 (xLSTM[3:1] ratio).
Recurrent O(1) decode state => long_500k RUNS for this arch.
"""
from repro_torch.configs.base import ModelConfig, XLSTMCfg

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    rope="none",
    act="gelu",
    tie_embeddings=True,
    xlstm=XLSTMCfg(slstm_period=4, slstm_at=1, chunk=256),
)
