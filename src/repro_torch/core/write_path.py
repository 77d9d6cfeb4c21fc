"""Boot-time weight write path (§IV-C) — the port of
``repro.core.write_path``.

At boot, H2PIPE ships weights from the host over PCIe, REUSING the
224x224x3 image input buffer and its datapath (no new BRAM), through a
deliberately NARROW bus (default 30 bits) that is deserialized to 256 bits
only at the HBM AXI controller — saving >3000 registers versus a full-width
path, acceptable because the write happens once.

We reproduce both halves:
  * the compiler side: ``pack_weights_as_images`` formats a weight blob as
    a sequence of image-shaped int8 frames (exactly the binary the H2PIPE
    compiler generates), ``unpack_weights`` inverts it, and the round trip
    is bit-exact (``tests/test_torch_write_path.py`` holds the frames to
    the JAX package's bit for bit);
  * the cost side: ``write_path_registers`` models the pipelined-bus
    register cost vs width, reproducing the ">3000 registers saved at 30
    bits" claim, and ``boot_time_s`` the one-time write latency given the
    Fig. 3a write efficiency.

On the card the analogue of the whole §IV-C is the host-to-device copy
at model load; the packing format itself is hardware-neutral and is what
a host-side loader would stream.  numpy in and out, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import hbm_model

IMAGE_BYTES = 224 * 224 * 3          # the reused input buffer, int8
DEFAULT_WIDTH_BITS = 30
FULL_WIDTH_BITS = 256
# distance from PCIe/input buffer to each HBM stack, in pipeline stages
# (deeply pipelined to meet timing across the die, §IV-C)
PIPELINE_STAGES_PER_STACK = 24


def pack_weights_as_images(weights: np.ndarray) -> np.ndarray:
    """Weight blob (any int8 array) -> [n_frames, 224, 224, 3] int8, padded
    with zeros; frames stream through the existing image input path."""
    flat = np.ascontiguousarray(weights, dtype=np.int8).reshape(-1)
    n_frames = -(-flat.size // IMAGE_BYTES)
    padded = np.zeros(n_frames * IMAGE_BYTES, np.int8)
    padded[:flat.size] = flat
    return padded.reshape(n_frames, 224, 224, 3)


def unpack_weights(frames: np.ndarray, size: int,
                   dtype=np.int8) -> np.ndarray:
    return frames.reshape(-1)[:size].astype(dtype)


def write_path_registers(width_bits: int = DEFAULT_WIDTH_BITS,
                         stacks: int = hbm_model.N_STACKS) -> int:
    """Register cost of the pipelined write bus: width x stages x stacks
    (plus the deserializer at the controller, one 256-bit stage)."""
    return width_bits * PIPELINE_STAGES_PER_STACK * stacks + FULL_WIDTH_BITS


def registers_saved(width_bits: int = DEFAULT_WIDTH_BITS) -> int:
    """§IV-C: 'saves over 3000 registers compared to a straightforward
    256-bit wide interface'."""
    return write_path_registers(FULL_WIDTH_BITS) - \
        write_path_registers(width_bits)


def boot_time_s(weight_bytes: int, width_bits: int = DEFAULT_WIDTH_BITS,
                burst: int = 8,
                fabric_mhz: float = hbm_model.FABRIC_MHZ) -> float:
    """One-time weight load latency: narrow-bus transfer then HBM writes at
    the measured write efficiency (the slower of the two pipelines)."""
    t_bus = weight_bytes * 8 / (width_bits * fabric_mhz * 1e6)
    w_bw = hbm_model.PC_BW_BYTES * hbm_model.write_efficiency(burst)
    t_hbm = weight_bytes / (w_bw * hbm_model.USABLE_PCS)
    return max(t_bus, t_hbm)
