"""Hardware constants.

Two machines appear in this repo:

* The paper's FPGA (Xilinx Alveo U250): 7 Computation Cores, each a 16x16 ALU
  array at 250 MHz.  Used verbatim by the paper-table reproduction benchmarks.
* The TARGET for the TPU adaptation: TPU v5e.  Used by the TPU cost model, the
  roofline analysis and the Pallas kernel tiling choices.

All numbers are per-chip unless stated otherwise.

This is a copy of ``repro.hw``: the port keeps both specs only because the
planner's cost models (``core.perf_model``) read them.  None of these
constants describes the GPU the port runs on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    """TPU v5e per-chip constants (assignment-provided)."""

    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12      # FLOP/s
    hbm_bandwidth: float = 819e9         # bytes/s
    ici_link_bandwidth: float = 50e9     # bytes/s per link
    hbm_bytes: int = 16 * 1024 ** 3      # 16 GiB HBM
    vmem_bytes: int = 64 * 1024 ** 2     # usable VMEM budget for kernel tiling
    mxu_dim: int = 128                   # systolic array edge -> tile alignment
    lane_dim: int = 128                  # minor-most vector lane count
    sublane_dim: int = 8                 # second-minor sublanes (fp32)


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    """Xilinx Alveo U250 configuration from the paper (Section VII)."""

    name: str = "alveo-u250"
    n_cores: int = 7                     # CC0-CC6 (SLR1 hosts shell + soft proc)
    p_sys: int = 16                      # ALU array edge per Computation Core
    freq_hz: float = 250e6               # accelerator clock
    ddr_bandwidth: float = 77e9          # bytes/s (Table V)
    on_chip_bytes: int = 45 * 1024 ** 2  # 45 MB (Table V)
    peak_flops: float = 0.512e12         # Table V


TPU_V5E = TPUSpec()
ALVEO_U250 = FPGASpec()
