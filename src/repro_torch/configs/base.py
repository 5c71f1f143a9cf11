"""Model configuration schema for the LM architecture zoo.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package).  One frozen dataclass describes every architecture;
family-specific sub-configs (MoE / MLA / Mamba / xLSTM / enc-dec) are
optional fields.  The port's model code (``repro_torch.models``) is
driven entirely by these values, and configs stay field-for-field equal to
the reference's.  ``jdtype`` returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    n_shared: int = 0              # always-on shared experts (DeepSeek)
    expert_d_ff: int = 0           # per-expert hidden width
    period: int = 1                # MoE every `period` layers (Jamba: 2)
    group_size: int = 256          # tokens per dispatch group
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256               # selective-scan chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def dt_rank(self, d_model: int) -> int:
        return max(d_model // 16, 1)


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    slstm_period: int = 4          # one sLSTM block every `period` layers
    slstm_at: int = 1              # its index within the period
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk: int = 256               # mLSTM parallel-form q-chunk


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int = 32
    dec_ratio: int = 8             # dec_len = seq_len // dec_ratio (stub
    #                                modality: enc frames dominate the shape)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope: str = "full"             # full | half | none
    rope_theta: float = 5e5
    act: str = "swiglu"            # swiglu | geglu | gelu (plain 2-matrix)
    norm: str = "rmsnorm"          # rmsnorm | layernorm (whisper)
    norm_eps: float = 1e-5
    qk_norm: bool = False          # Chameleon
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    encdec: Optional[EncDecCfg] = None
    attn_period: int = 1           # attention every N layers (Jamba: 8)
    attn_at: int = 0               # its index within the period
    dense_first_n: int = 0         # DeepSeek: first N layers use dense FFN
    d_ff_dense: int = 0            # width of those dense layers
    dtype: str = "bfloat16"
    # --- runtime knobs (not architecture) ---
    scan_layers: bool = True       # scan-over-layers (memory/real path) vs
    #                                unrolled (cost-extrapolation proxies)
    attn_impl: str = "chunked"     # chunked | einsum | flash
    attn_chunk: int = 512
    remat: bool = True
    logit_chunk: int = 8           # CE computed in seq chunks
    dynasparse_ffn: bool = False   # route FFN matmuls through dynasparse
    opt_state_dtype: str = "float32"   # bf16 for the 100B+ archs; "int8"
    #                                    = blockwise-quantized m/v (perf
    #                                    hillclimb, EXPERIMENTS.md sec Perf)
    mla_absorbed: bool = False     # MLA decode matrix absorption (hillclimb)
    kv_cache_dtype: str = ""       # "" = model dtype; "float8_e4m3fn" halves
    #                                cache bytes (decode perf hillclimb)
    moe_ep: bool = False           # experts sharded over the data axis (EP)
    #                                instead of FSDP-gathered (hillclimb)
    vocab_parallel_ce: bool = False  # CE over model-sharded logits: kills
    #                                  the (T,V) fp32 data-axis all-reduce
    #                                  (collective hillclimb)

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def jdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def layer_period(self) -> int:
        """Heterogeneity period of the stack (for period-wise layer scan)."""
        p = self.attn_period
        if self.moe is not None:
            p = _lcm(p, self.moe.period)
        if self.xlstm is not None:
            p = _lcm(p, self.xlstm.slstm_period)
        return p

    @property
    def n_periods(self) -> int:
        assert self.n_scan_layers % self.layer_period == 0, (
            self.name, self.n_layers, self.layer_period)
        return self.n_scan_layers // self.layer_period

    @property
    def n_scan_layers(self) -> int:
        """Layers inside the scanned/stacked region (excludes dense_first_n)."""
        return self.n_layers - self.dense_first_n

    def layer_kind(self, idx_in_period: int) -> dict:
        """What lives at period position idx: mixer + ffn type."""
        if self.xlstm is not None:
            mixer = ("slstm" if idx_in_period % self.xlstm.slstm_period
                     == self.xlstm.slstm_at else "mlstm")
            return {"mixer": mixer, "ffn": "none"}
        mixer = ("attn" if idx_in_period % self.attn_period == self.attn_at
                 else "mamba")
        ffn = "dense"
        if self.moe is not None and idx_in_period % self.moe.period == (
                self.moe.period - 1):
            ffn = "moe"
        return {"mixer": mixer, "ffn": ffn}

    def active_params(self, seq_len: int = 0) -> float:
        """N_active for MODEL_FLOPS = 6*N_active*D (MoE counts top-k only)."""
        return _count_params(self, active_only=True)

    def total_params(self) -> float:
        return _count_params(self, active_only=False)


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> float:
    mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> float:
    hd = cfg.head_dim_
    if cfg.mla is not None:
        m = cfg.mla
        q = cfg.d_model * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
        dkv = cfg.d_model * (m.kv_lora_rank + m.qk_rope_dim)
        up = m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        o = cfg.n_heads * m.v_head_dim * cfg.d_model
        return q + dkv + up + o
    return cfg.d_model * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _mamba_params(cfg: ModelConfig) -> float:
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    dr = m.dt_rank(cfg.d_model)
    return (cfg.d_model * 2 * di + di * m.d_conv + di * (dr + 2 * m.d_state)
            + dr * di + di * m.d_state + di + di * cfg.d_model)


def _xlstm_params(cfg: ModelConfig, kind: str) -> float:
    x = cfg.xlstm
    d = cfg.d_model
    if kind == "mlstm":
        di = int(d * x.mlstm_proj_factor)
        # up(2x), q/k/v, gates(2 per head), out, down
        return d * 2 * di + 3 * di * di + 2 * di + di * d
    di = int(d * x.slstm_proj_factor)
    # 4 gates input + 4 recurrent (block-diag per head) + ffn
    return d * 4 * d + 4 * d * (d // 4) + d * di + di * d


def _count_params(cfg: ModelConfig, active_only: bool) -> float:
    total = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    layers = []
    for i in range(cfg.dense_first_n):
        layers.append({"mixer": "attn", "ffn": "dense_first"})
    for i in range(cfg.n_scan_layers):
        layers.append(cfg.layer_kind(i % cfg.layer_period))
    for lk in layers:
        if lk["mixer"] == "attn":
            total += _attn_params(cfg)
        elif lk["mixer"] == "mamba":
            total += _mamba_params(cfg)
        elif lk["mixer"] in ("mlstm", "slstm"):
            total += _xlstm_params(cfg, lk["mixer"])
        if lk["ffn"] == "dense":
            total += _ffn_params(cfg, cfg.d_ff)
        elif lk["ffn"] == "dense_first":
            total += _ffn_params(cfg, cfg.d_ff_dense or cfg.d_ff)
        elif lk["ffn"] == "moe":
            moe = cfg.moe
            dff = moe.expert_d_ff or cfg.d_ff
            n_used = (moe.top_k if active_only else moe.n_experts)
            total += _ffn_params(cfg, dff) * (n_used + moe.n_shared)
            total += cfg.d_model * moe.n_experts  # router
    if cfg.encdec is not None:
        # decoder layers add cross-attention
        total += cfg.n_layers * _attn_params(cfg)
    return float(total)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
