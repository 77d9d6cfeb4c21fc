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
