"""Seeded inputs and helpers shared by the port's tests
(tests/test_torch_*.py)."""
import contextlib

import numpy as np


def numpy_cnn_params(cfg, seed):
    """Seeded int8 weights, per-channel scales and biases for every
    weighted node of a CNN config, as numpy arrays: what both packages
    are given."""
    rng = np.random.default_rng(seed)
    out = {}
    for spec in cfg.layers:
        if spec.is_pool:
            continue
        dw = spec.kind == "dwconv"
        c_out = spec.c_in if dw else spec.c_out
        shape = (spec.k_h, spec.k_w, 1 if dw else spec.c_in, c_out)
        out[spec.name] = {
            "w": rng.integers(-127, 128, size=shape, dtype=np.int8),
            "w_scale": rng.uniform(0.01, 0.06, c_out).astype(np.float32),
            "bias": rng.normal(0.0, 0.5, c_out).astype(np.float32)}
    return out


def wide_conv_cfg(m):
    """A config of module ``m`` (either package's ``configs.cnn``): one 3x3
    conv, C 2048 -> 16 on a 4x64 map, that no pinned launch plan of the
    card fits (9 taps of 16 x 2064 bytes of weights alone exceed a block)
    and a streamed one does; then a global average pool and an fc head.
    At 64 columns a chain feed costs 22 tensor blocks, so the parallelism
    pass leaves the conv 64 feeds, within the pseudo-channel pool that
    re-placement may draw from (at 4x4 it would take 512)."""
    return m.CNNConfig("wide3x3", (
        m.ConvLayerSpec("wide", "conv", 3, 3, 2048, 16, 1, 4, 64),
        m.ConvLayerSpec("gap", "gap", 4, 64, 16, 16, 64, 4, 64),
        m.ConvLayerSpec("fc", "fc", 1, 1, 16, 16, 1, 1, 1)),
        num_classes=16)


@contextlib.contextmanager
def moe_routing(forced=None):
    """Reads or forces the MoE routing of what runs inside.  Yields a list
    that gets, call by call, the top-k experts ``[T, k]`` each MoE layer
    took.  With ``forced`` (such a list, in the same order) each call
    takes the next one's experts instead of its router's top-k, its gates
    the router's probabilities renormalised over them.  Patches
    ``repro_torch.models.ffn.top_k``, which ``moe_router`` calls once a
    layer."""
    from repro_torch.models import ffn
    own = ffn.top_k
    it = None if forced is None else iter(forced)
    taken = []

    def top_k(probs, k):
        if it is None:
            p, e = own(probs, k)
        else:
            e = next(it).reshape(*probs.shape[:-1], k).to(probs.device)
            p = probs.gather(-1, e)
        taken.append(e.reshape(-1, k))
        return p, e

    ffn.top_k = top_k
    try:
        yield taken
    finally:
        ffn.top_k = own
