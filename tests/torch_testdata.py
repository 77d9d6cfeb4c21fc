"""Seeded inputs shared by the port's CPU tests (tests/test_torch_*.py)."""
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
