"""NVIDIA H100 SXM5 constants for the roofline and the kernel bounds.

The card: NVIDIA H100 80GB HBM3 at a 700 W power limit (what
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reads
on the machine these were checked on).  Peaks are the dense rates of
NVIDIA's H100 SXM5 data sheet (no sparsity); a card set below 700 W runs
slower under load.  The reference's names stand where a reader of the
JAX package looks for them (``PEAK_FLOPS_BF16``, ``HBM_BW``,
``HBM_BYTES``, ``VMEM_BYTES``, ``ICI_BW_PER_LINK``, ``ICI_LINKS``).

The link: the dry run's collective term (``analysis.Roofline.
t_collective``) is a device's collective bytes over ``ICI_BW_PER_LINK x
ICI_LINKS``, the reference's formula, with NVLink 4's 18 links of 25 GB/s
a direction standing for the TPU's ICI on every mesh axis.  That holds
inside one NVLink domain (a host's cards, all to all).  The production
meshes are larger than one: on 2 x 16 x 16 the pod axis, and in practice
the data axis too, leave the domain for the network between hosts, which
is slower; the term is then a lower bound.  No knob models it, as the
reference has none.
"""
from __future__ import annotations

# tensor cores, dense (H100 SXM5 data sheet: 989.4 TFLOP/s bf16,
# 1,978.9 TOP/s int8)
PEAK_FLOPS_BF16 = 9.89e14
PEAK_FLOPS_INT8 = 1.979e15
# tf32 on the tensor cores, dense (data sheet: 494.7 TFLOP/s)
PEAK_FLOPS_TF32 = 4.95e14
# FFMA on the CUDA cores, no TF32 (data sheet: 66.9 TFLOP/s FP32)
PEAK_FLOPS_FP32 = 6.7e13

# HBM3: 3.35 TB/s (data sheet), 80 GiB of stacks (79.6 GiB usable)
HBM_BW = 3.35e12
HBM_BYTES = 80 * 2**30

# NVLink 4: 18 links, 900 GB/s in both directions together, so 25 GB/s
# a link in each direction
NVLINK_LINKS = 18
NVLINK_BW_PER_LINK = 25e9
ICI_LINKS = NVLINK_LINKS
ICI_BW_PER_LINK = NVLINK_BW_PER_LINK

# on chip: 132 SMs, 228 KiB of shared memory an SM of which a CTA may
# take 227 KiB (the opt-in maximum), 50 MiB of L2
SM_COUNT = 132
SMEM_BYTES_PER_SM = 228 * 2**10
SMEM_BYTES_PER_CTA = 227 * 2**10
SMEM_BYTES_TOTAL = SM_COUNT * SMEM_BYTES_PER_SM
L2_BYTES = 50 * 2**20
#: the resident capacity the streamed matmul's pinned mode can use: the
#: card's shared memory (the JAX package's name for a TPU core's VMEM)
VMEM_BYTES = SMEM_BYTES_TOTAL
