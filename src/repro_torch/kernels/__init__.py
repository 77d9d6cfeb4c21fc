"""Hand-written CUDA kernels for Hopper (``csrc/``) with their wrappers
and plain PyTorch versions.

conv2d_int8    HPIPE layer engine: line-buffer row conv, pinned or
               streamed weight taps, dp4a int8 MACs, fused requant;
               with ``depthwise=True`` the grouped MobileNet engine
               (``csrc/dwconv_int8.cu``: per-channel int32 MACs)
pool_int8      the pooling topology engines: SAME maxpool and global
               average pool (+ activation requantizer)
stream_matmul  the fc heads: W's K-blocks through an n_buffers ring
flash_attention  the LM attention: online-softmax forward with causal /
               window / softcap masking, GQA, and the lse; the backward
               pair (dq; dk and dv) and the differentiable wrapper

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built on first use by ``_build``) or raises.
"""
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.conv2d_int8.ops import (  # noqa: F401
    conv2d_int8, conv2d_int8_requant)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_kernel,
    flash_attention_vjp)
from repro_torch.kernels.pool_int8.ops import (  # noqa: F401
    global_avgpool_int8, maxpool_int8)
from repro_torch.kernels.stream_matmul.ops import (  # noqa: F401
    stream_matmul, stream_matmul_requant)

__all__ = ["stream_matmul", "conv2d_int8", "conv2d_int8_requant",
           "maxpool_int8", "global_avgpool_int8", "flash_attention",
           "stream_matmul_requant", "flash_attention_bwd",
           "flash_attention_kernel", "flash_attention_vjp", "LAUNCHES",
           "reset_launches"]
