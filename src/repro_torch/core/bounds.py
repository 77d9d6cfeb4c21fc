"""Throughput upper bounds — Eq. 2 and the Fig. 6 analysis.

Three bounds, exactly as the paper constructs them:
  1. all-HBM bound: effective HBM bandwidth (279 GB/s: 31 PCs x 240 bits @
     300 MHz, 100% efficiency) / weight traffic per image (Eq. 2 — kernels
     are re-read once per output row because HPIPE parallelizes across the
     full activation width);
  2. compute bound at a given tensor-block count (each AI-TB: 3 dot-10s =
     30 int8 MACs per cycle @ 300 MHz);
  3. unlimited-HBM bound: grow compute to the 85%-utilization limit of the
     device and take the compute bound there (the light-green bar).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.cnn import CNNConfig
from repro_torch.core import hbm_model

AI_TB_MACS_PER_CYCLE = 30
NX2100_TENSOR_BLOCKS = 3960
NX2100_M20KS = 6847               # ~140 Mb of M20K on Stratix 10 NX2100
UTIL_LIMIT = 0.85                 # §VI-B unlimited-bandwidth experiment


def eq2_weight_traffic_bytes(cfg: CNNConfig, bits: int = 8) -> int:
    """MT_required = sum_l k_h*k_w*c_i*c_o*output_height (bytes at 8-bit)."""
    return cfg.total_weight_traffic(bits)


def all_hbm_bound_ims(cfg: CNNConfig) -> float:
    """Throughput if weights stream perfectly from HBM (Fig. 6 light blue)."""
    return hbm_model.EFFECTIVE_BW_BYTES / eq2_weight_traffic_bytes(cfg)


def compute_bound_ims(cfg: CNNConfig,
                      tensor_blocks: int = NX2100_TENSOR_BLOCKS,
                      fabric_mhz: float = hbm_model.FABRIC_MHZ) -> float:
    """Peak images/s if every AI-TB ran every cycle."""
    macs = cfg.total_macs()
    return tensor_blocks * AI_TB_MACS_PER_CYCLE * fabric_mhz * 1e6 / macs


def unlimited_hbm_bound_ims(cfg: CNNConfig, hybrid_ims: float,
                            used_tbs: int,
                            device_tbs: int = NX2100_TENSOR_BLOCKS) -> float:
    """Fig. 6 light green: unlimited HBM stacks and the DSP count grown to
    the 85%-utilization limit (§VI-B).  Throughput scales with compute until
    that limit: hybrid x (0.85*device / used).  Paper: 2.27x on ResNet-50,
    2.08x on VGG-16, ~1x on ResNet-18."""
    scale = max(1.0, UTIL_LIMIT * device_tbs / max(used_tbs, 1))
    return hybrid_ims * scale


def gops(cfg: CNNConfig, images_per_s: float) -> float:
    """Table III GOPs convention: 2*MACs per image."""
    return 2 * cfg.total_macs() * images_per_s / 1e9


def fig6_summary(cfg: CNNConfig, hw_all_hbm: float, hw_hybrid: float,
                 used_tbs: int) -> Dict[str, float]:
    bound = all_hbm_bound_ims(cfg)
    return {
        "all_hbm_hw": hw_all_hbm,
        "hybrid_hw": hw_hybrid,
        "all_hbm_bound": bound,
        "unlimited_bound": unlimited_hbm_bound_ims(cfg, hw_hybrid, used_tbs),
        "fraction_of_bound": hw_all_hbm / bound,
    }
