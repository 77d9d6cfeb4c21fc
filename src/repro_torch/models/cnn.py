"""CNN models built from the H2PIPE per-layer descriptors, on PyTorch.

``init_cnn_params`` / ``cnn_forward`` consume the same ``ConvLayerSpec``s
that drive the placement algorithm (Eq. 1), the memory table (Table I)
and the traffic bound (Eq. 2), so the numbers refer to the exact network
that runs.

Numerics follow the paper: int8 weights with per-output-channel scales;
activations int8 with a per-tensor scale.  Every conv accumulates exactly
in integers and requantizes through the shared epilogue
(``kernels/quant.py``).  The functions here are the plain reference the
pipeline executor is held against; they run on whatever device their
tensors are on.  Activations are NHWC int8 and weights HWIO int8.
``conv_layer_specs`` and ``cnn_param_specs`` give the partition specs
(copies of the JAX package's; the port runs no partitioner).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.cnn import (CNNConfig, ConvLayerSpec, ResBlockSpec,
                                     residual_blocks, stem_unit)
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref
from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                               maxpool_int8_ref)
from repro_torch.kernels.quant import requant_epilogue
from repro_torch.models.layers import MODEL_AXIS, P, maybe_axis

Params = Dict[str, Dict[str, torch.Tensor]]


def _conv_shapes(spec: ConvLayerSpec) -> Tuple[Tuple[int, ...], int]:
    """(HWIO weight shape, output channels) of one layer."""
    if spec.kind == "dwconv":
        return (spec.k_h, spec.k_w, 1, spec.c_in), spec.c_in  # depthwise
    return (spec.k_h, spec.k_w, spec.c_in, spec.c_out), spec.c_out


def init_conv_layer(spec: ConvLayerSpec, generator: torch.Generator,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Random int8 weights in [-127, 127] drawn from ``generator`` (on the
    generator's device, then moved to ``device``), scales 0.05, bias 0."""
    w_shape, c_out = _conv_shapes(spec)
    w = torch.randint(-127, 128, w_shape, generator=generator,
                      dtype=torch.int8, device=generator.device)
    return {
        "w": w.to(device),
        "w_scale": torch.full((c_out,), 0.05, dtype=torch.float32,
                              device=device),
        "bias": torch.zeros((c_out,), dtype=torch.float32, device=device),
    }


def init_cnn_params(cfg: CNNConfig, generator: torch.Generator,
                    device="cuda") -> Params:
    """Parameters for every weighted node; pool nodes (maxpool / GAP) are
    weightless topology engines and get no entry."""
    return {l.name: init_conv_layer(l, generator, device)
            for l in cfg.layers if not l.is_pool}


def abstract_cnn_params(cfg: CNNConfig) -> Params:
    """``init_cnn_params``'s shapes and dtypes as ``meta`` tensors: nothing
    drawn or allocated (the JAX package's ``jax.eval_shape`` of it)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    for l in cfg.layers:
        if l.is_pool:
            continue
        w_shape, c_out = _conv_shapes(l)
        out[l.name] = {"w": meta(w_shape, torch.int8),
                       "w_scale": meta((c_out,), torch.float32),
                       "bias": meta((c_out,), torch.float32)}
    return out


def conv_layer_specs(spec: ConvLayerSpec) -> Dict[str, P]:
    """The partition specs of one layer's params (output channels over
    ``model`` where it divides them), as the JAX package's."""
    ax = maybe_axis(spec.c_in if spec.kind == "dwconv" else spec.c_out,
                    MODEL_AXIS)
    return {"w": P(None, None, None, ax), "w_scale": P(ax), "bias": P(ax)}


def cnn_param_specs(cfg: CNNConfig) -> Dict[str, Dict[str, P]]:
    return {l.name: conv_layer_specs(l) for l in cfg.layers if not l.is_pool}


def conv_layer_forward(params: Dict[str, torch.Tensor], spec: ConvLayerSpec,
                       x: torch.Tensor, act_scale: float = 0.05,
                       relu: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,H,W,C] int8.  Returns (int8 activations, f32 pre-quant)."""
    y = conv2d_int8_ref(x, params["w"], stride=spec.stride,
                        padding="SAME" if spec.kind != "fc" else "VALID",
                        depthwise=spec.kind == "dwconv")
    return requant_epilogue(y, params["w_scale"], params["bias"],
                            act_scale=act_scale, relu=relu)


def pool_forward(spec: ConvLayerSpec, x: torch.Tensor,
                 act_scale: float = 0.05) -> torch.Tensor:
    """The plain reference for one pooling topology node."""
    if spec.kind == "maxpool":
        return maxpool_int8_ref(x, k=spec.k_h, stride=spec.stride)
    if spec.kind != "gap":
        raise ValueError(f"not a pool node: {spec.kind!r}")
    return global_avgpool_int8_ref(x, act_scale=act_scale)


# engine(spec, layer_params, x, relu) -> Optional[(y_q, y_float)].  The
# per-layer dispatch hook the pipeline executor plugs in; returning None
# falls back to the plain reference path here.
EngineHook = Callable[[ConvLayerSpec, Dict[str, torch.Tensor], torch.Tensor,
                       bool],
                      Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]]

# block_engine(block, params, x) -> Optional[y_q]: a whole residual block
# (or the stem conv + maxpool unit) offered as ONE unit.
BlockEngineHook = Callable[[ResBlockSpec, Params, torch.Tensor],
                           Optional[torch.Tensor]]

# scan_engine(lead_block, params, x, limit) -> Optional[(y_q, consumed)]:
# offered at the LEAD block of each residual block, BEFORE the block hook;
# accepting executes a whole homogeneous run of blocks and consumes
# ``consumed`` member layers (``limit`` layers remain in the range).
ScanEngineHook = Callable[[ResBlockSpec, Params, torch.Tensor, int],
                          Optional[Tuple[torch.Tensor, int]]]


def residual_join(h: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
    """int32 add, clip to +-127, relu — back to int8."""
    y = h.to(torch.int32) + identity.to(torch.int32)
    return torch.clamp(y, 0, 127).to(torch.int8)


def cnn_forward(params: Params, cfg: CNNConfig, images: torch.Tensor,
                engine: Optional[EngineHook] = None,
                block_engine: Optional[BlockEngineHook] = None,
                scan_engine: Optional[ScanEngineHook] = None,
                layer_range: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """Plain feed-forward execution (the functional reference; the
    pipeline executor runs the same layers through the CUDA engines by
    passing the hooks).

    images: [B,224,224,3] (or reduced) int8.  Returns logits [B,classes].
    Residual wiring comes from ``configs.cnn.residual_blocks``; maxpool
    and GAP are graph nodes in ``cfg.layers`` offered to ``engine`` like
    any conv.  Hooks that decline (return None) leave the node to the
    plain path, so every node executes exactly once either way.

    ``layer_range``: ``(start, stop)`` indices into ``cfg.layers`` — run
    only that slice; when it stops before the final layer the return
    value is the int8 activation feeding layer ``stop``.  A range may not
    start or stop inside a residual block.
    """

    def apply_layer(spec: ConvLayerSpec, x, relu: bool = True):
        if engine is not None:
            out = engine(spec, params.get(spec.name, {}), x, relu)
            if out is not None:
                return out
        if spec.is_pool:
            return pool_forward(spec, x), None
        return conv_layer_forward(params[spec.name], spec, x, relu=relu)

    x = images
    layers = list(cfg.layers)
    blocks = {b.convs[0].name: b for b in residual_blocks(cfg)}
    start, stop = (0, len(layers)) if layer_range is None else layer_range
    if not 0 <= start < stop <= len(layers):
        raise ValueError(
            f"layer_range {layer_range} outside [0, {len(layers)})")
    member_head = {m.name: b.convs[0].name
                   for b in residual_blocks(cfg) for m in b.members}
    for cut, where in ((start, "start"), (stop, "stop")):
        if cut < len(layers):
            name = layers[cut].name
            if name in member_head and member_head[name] != name:
                raise ValueError(
                    f"layer_range {where}={cut} cuts residual block "
                    f"{member_head[name]!r} open at member {name!r}; "
                    f"stage cuts must treat blocks as atomic units")
    stem = stem_unit(cfg)
    i = start
    while i < stop:
        spec = layers[i]
        name = spec.name
        if (stem is not None and name == stem.conv.name and i + 2 <= stop
                and block_engine is not None):
            out = block_engine(stem, params, x)
            if out is not None:
                x = out
                i += 2
                continue
        if spec.is_pool:
            x, _ = apply_layer(spec, x, relu=False)
            i += 1
            continue
        if name in blocks:
            blk = blocks[name]
            if scan_engine is not None:
                out = scan_engine(blk, params, x, stop - i)
                if out is not None:
                    x, consumed = out
                    i += consumed
                    continue
            if block_engine is not None:
                out = block_engine(blk, params, x)
                if out is not None:
                    x = out
                    i += len(blk.members)
                    continue
            identity = x
            h = x
            for ci, cspec in enumerate(blk.convs):
                last = ci == len(blk.convs) - 1
                h, _ = apply_layer(cspec, h, relu=not last)
            if blk.ds is not None:
                identity, _ = apply_layer(blk.ds, identity, relu=False)
            x = residual_join(h, identity)
            i += len(blk.members)
            continue
        if name.startswith("fc") or name in ("head0", "head1", "head"):
            last = i == len(layers) - 1
            x, y_f = apply_layer(spec, x, relu=not last)
            if last:
                return y_f.reshape(y_f.shape[0], -1)
            i += 1
            continue
        x, _ = apply_layer(spec, x)
        i += 1
    if stop < len(layers):
        return x                  # int8 stage-boundary activation
    # no explicit fc tail (shouldn't happen) — pool and return
    return x.to(torch.float32).mean(dim=(1, 2))


def cnn_input_shape(cfg: CNNConfig, batch: int) -> Tuple[int, int, int, int]:
    l0 = cfg.layers[0]
    return (batch, l0.in_h, l0.in_w, l0.c_in)
