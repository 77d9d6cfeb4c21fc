"""The paper's own CNNs as per-layer descriptors.

H2PIPE's compiler reasons about a CNN layer-by-layer: kernel shape, channel
counts and output spatial size determine weight memory (Table I), weight
traffic per image (Eq. 2) and the HBM-offload score (Eq. 1).  We reproduce
that representation exactly; the same descriptors drive the JAX model
builders in ``repro_torch.models.cnn``.

All networks use 224x224x3 ImageNet inputs and int8 weights (the paper's
precision), with HPIPE conventions:
  * activations buffered on chip as a sliding window of ``k_h`` lines
    (+1 line being written) per layer input,
  * weights re-read once per output row when streamed from HBM (Eq. 2).

Topology ops are first-class nodes: maxpool (``kind="maxpool"``) and
global-average-pool (``kind="gap"``) layers appear in ``CNNConfig.layers``
like every conv, so the compiler places, costs and binds 100% of the graph
— the paper emits a hardware engine for every node, pooling included; no
wiring hides inside the model's forward function.  Pool nodes carry zero
weights (they never stream, Eq. 2 words are 0) but real activation
buffers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

#: Weightless topology kinds: placed and costed like any engine, but with
#: no weight memory, no Eq. 2 traffic, and no AI-TB parallelism to balance.
POOL_KINDS = ("maxpool", "gap")


@dataclass(frozen=True)
class ConvLayerSpec:
    """One CNN graph node (conv, fc-as-conv, or pooling) as H2PIPE sees it."""

    name: str
    kind: str                 # conv | dwconv | pwconv | fc | maxpool | gap
    k_h: int
    k_w: int
    c_in: int
    c_out: int
    stride: int
    in_h: int
    in_w: int

    @property
    def is_pool(self) -> bool:
        return self.kind in POOL_KINDS

    @property
    def out_h(self) -> int:
        """SAME-padded output rows: ceil(in_h / stride) — the row count
        the kernels actually emit, so Eq. 2 analytics (words per image =
        words per row x out_h) and executed dispatch counters agree for
        every geometry, odd maps included."""
        return -(-self.in_h // self.stride)

    @property
    def out_w(self) -> int:
        return -(-self.in_w // self.stride)

    @property
    def weight_count(self) -> int:
        if self.is_pool:
            return 0                  # comparators/accumulators, no weights
        if self.kind == "dwconv":
            return self.k_h * self.k_w * self.c_in
        return self.k_h * self.k_w * self.c_in * self.c_out

    def weight_bits(self, bits: int = 8) -> int:
        return self.weight_count * bits

    @property
    def macs(self) -> int:
        """Multiply-accumulates for one image (pool nodes do comparator /
        accumulator work on the fabric, not MACs on the tensor blocks)."""
        if self.is_pool:
            return 0
        if self.kind == "dwconv":
            return self.k_h * self.k_w * self.c_in * self.out_h * self.out_w
        return (self.k_h * self.k_w * self.c_in * self.c_out
                * self.out_h * self.out_w)

    def weight_traffic_bytes(self, bits: int = 8) -> int:
        """Eq. 2 term: kernels are re-read once per output line."""
        return self.weight_bits(bits) // 8 * self.out_h

    def activation_window_bits(self, bits: int = 8) -> int:
        """On-chip activation line buffer: k_h input lines + 1 in flight,
        double-buffered (HPIPE duplicates activation buffers for Fmax).
        A GAP node needs no line window — one input row in flight plus a
        32-bit per-channel accumulator."""
        if self.kind == "gap":
            return (self.in_w * self.c_in * bits + self.c_in * 32) * 2
        lines = self.k_h + 1
        return self.in_w * self.c_in * lines * bits * 2


@dataclass(frozen=True)
class CNNConfig:
    name: str
    layers: Tuple[ConvLayerSpec, ...]
    num_classes: int = 1000

    def total_weight_bits(self, bits: int = 8) -> int:
        return sum(l.weight_bits(bits) for l in self.layers)

    def total_activation_bits(self, bits: int = 8) -> int:
        return sum(l.activation_window_bits(bits) for l in self.layers)

    def total_weight_traffic(self, bits: int = 8) -> int:
        return sum(l.weight_traffic_bytes(bits) for l in self.layers)

    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    def reduced(self) -> "CNNConfig":
        """Tiny CIFAR-scale variant for smoke tests: keep the topology family,
        shrink depth/channels.  Pool nodes inside the kept prefix survive
        (shapes recomputed); a GAP node is re-synthesized before the first
        fc head when the map is still spatial, so the reduced graph — like
        the full one — contains every topology op as an explicit node."""
        keep = [l for i, l in enumerate(self.layers) if i < 4 or l.kind == "fc"]
        small: List[ConvLayerSpec] = []
        h, w = 32, 32
        c_prev = 3
        for l in keep:
            if l.kind == "gap":
                continue              # re-synthesized before the fc head
            if l.kind == "maxpool":
                small.append(dataclasses.replace(
                    l, c_in=c_prev, c_out=c_prev, in_h=h, in_w=w))
                h, w = max(1, h // l.stride), max(1, w // l.stride)
                continue
            c_in = c_prev
            c_out = min(l.c_out, 16)
            if l.kind == "dwconv":
                c_out = c_in
            stride = l.stride
            k_h, k_w = l.k_h, l.k_w
            if l.kind == "fc":          # fc-as-conv runs on the pooled 1x1 map
                if h > 1 or w > 1:      # explicit GAP node feeds the head
                    small.append(_gap(c_in, h, w))
                k_h = k_w = stride = 1
                h = w = 1
            small.append(dataclasses.replace(
                l, c_in=c_in, c_out=c_out, in_h=h, in_w=w,
                k_h=k_h, k_w=k_w, stride=stride))
            c_prev = c_out
            h, w = max(1, h // stride), max(1, w // stride)
        return CNNConfig(self.name + "-reduced", tuple(small), num_classes=10)


@dataclass(frozen=True)
class ResBlockSpec:
    """One residual block as a schedulable unit: the conv chain, the
    optional pointwise downsample on the identity path, and the add+relu
    join.  H2PIPE places whole engines, not abstract layers — grouping
    the block lets the compiler bind it to a single fused engine
    (``res_block_int8``) with its own VMEM cost and Eq. 2 accounting."""

    name: str                           # "s{i}b{j}" block prefix
    convs: Tuple[ConvLayerSpec, ...]    # main-path convs, pipeline order
    ds: Optional[ConvLayerSpec]         # identity-path downsample (or None)

    @property
    def members(self) -> Tuple[ConvLayerSpec, ...]:
        """All member layers in config order (convs then downsample —
        the order the config builders emit them)."""
        return self.convs + ((self.ds,) if self.ds is not None else ())


def residual_blocks(cfg: "CNNConfig") -> Tuple[ResBlockSpec, ...]:
    """Group a ResNet-family config's layers into residual blocks, by the
    same ``s{i}b{j}c{k}`` / ``...ds`` naming walk ``cnn_forward`` wires
    the adds with — the single source of truth for block membership that
    both the model topology and the compiler's block binding share.
    Non-ResNet configs (no block structure) return ()."""
    if not cfg.name.startswith("resnet"):
        return ()
    blocks: List[ResBlockSpec] = []
    layers = list(cfg.layers)
    i = 0
    while i < len(layers):
        name = layers[i].name
        if not (name[0] == "s" and "b" in name and "c" in name):
            i += 1
            continue
        prefix = name[:name.index("c")]
        members = [layers[i]]
        j = i + 1
        while j < len(layers) and layers[j].name.startswith(prefix):
            members.append(layers[j])
            j += 1
        ds = [m for m in members if m.name.endswith("ds")]
        convs = tuple(m for m in members if not m.name.endswith("ds"))
        blocks.append(ResBlockSpec(name=prefix, convs=convs,
                                   ds=ds[0] if ds else None))
        i = j
    return tuple(blocks)


def block_shape_signature(block: ResBlockSpec) -> Tuple:
    """Name-independent shape signature of a residual block: member
    kinds, kernel/channel/stride/input geometry, conv count and
    downsample presence.  Two blocks with equal signatures run the SAME
    computation on same-shaped tensors — the compile-time condition for
    folding them into one scanned body (their weights stack along a
    leading axis; only the values differ)."""
    def sig(m: ConvLayerSpec) -> Tuple:
        return (m.kind, m.k_h, m.k_w, m.c_in, m.c_out, m.stride,
                m.in_h, m.in_w)
    return ((len(block.convs), block.ds is not None)
            + tuple(sig(m) for m in block.members))


def homogeneous_block_runs(cfg: "CNNConfig", min_run: int = 2
                           ) -> Tuple[Tuple[ResBlockSpec, ...], ...]:
    """Maximal runs of >= ``min_run`` CONSECUTIVE residual blocks (adjacent
    in ``cfg.layers``, no interleaving nodes) with identical
    :func:`block_shape_signature` — e.g. each ResNet-50 stage minus its
    stride-2 / expanding lead block.  These are the scan candidates the
    compiler turns into :class:`~repro_torch.core.schedule.ScanGroup`\\ s; the
    dw/pw alternation of the MobileNets has no residual blocks at all, so
    they (correctly) yield zero runs."""
    blocks = residual_blocks(cfg)
    if not blocks:
        return ()
    idx = {l.name: i for i, l in enumerate(cfg.layers)}
    span = {b.name: (idx[b.members[0].name], idx[b.members[-1].name] + 1)
            for b in blocks}
    runs: List[Tuple[ResBlockSpec, ...]] = []
    cur: List[ResBlockSpec] = [blocks[0]]
    for prev, b in zip(blocks, blocks[1:]):
        if (span[prev.name][1] == span[b.name][0]
                and block_shape_signature(b) == block_shape_signature(prev)):
            cur.append(b)
        else:
            if len(cur) >= min_run:
                runs.append(tuple(cur))
            cur = [b]
    if len(cur) >= min_run:
        runs.append(tuple(cur))
    return tuple(runs)


@dataclass(frozen=True)
class StemUnitSpec:
    """The stem conv + its following maxpool as ONE schedulable unit —
    the same block-unit machinery residual blocks use, so the stem no
    longer dispatches as two separate nodes.  ``name`` is the stem
    conv's layer name (the unit dispatches at its head, like a residual
    block does at its first conv)."""

    name: str
    conv: ConvLayerSpec
    pool: ConvLayerSpec

    @property
    def members(self) -> Tuple[ConvLayerSpec, ...]:
        return (self.conv, self.pool)


def stem_unit(cfg: "CNNConfig") -> Optional[StemUnitSpec]:
    """The fusable stem unit of ``cfg``: its first two layers, when they
    are exactly a conv followed by a maxpool (the ResNet-family stem).
    Configs whose stem feeds something else (VGG's conv-conv, the
    MobileNets' conv-dwconv) have no stem unit — None."""
    if (len(cfg.layers) >= 2 and cfg.layers[0].kind == "conv"
            and cfg.layers[1].kind == "maxpool"):
        return StemUnitSpec(name=cfg.layers[0].name,
                            conv=cfg.layers[0], pool=cfg.layers[1])
    return None


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _maxpool(name: str, c: int, h: int, w: int, *, k: int = 2,
             stride: int = 2) -> ConvLayerSpec:
    """Explicit maxpool node (c_out == c_in, zero weights)."""
    return ConvLayerSpec(name, "maxpool", k, k, c, c, stride, h, w)


def _gap(c: int, h: int, w: int, name: str = "gap") -> ConvLayerSpec:
    """Global-average-pool node: the whole map is the window, out is 1x1."""
    return ConvLayerSpec(name, "gap", h, w, c, c, max(h, w), h, w)


def _vgg16() -> CNNConfig:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    layers: List[ConvLayerSpec] = []
    h = w = 224
    c_in = 3
    i = 0
    pi = 0
    for v in cfg:
        if v == "M":
            layers.append(_maxpool(f"pool{pi}", c_in, h, w))
            pi += 1
            h //= 2
            w //= 2
            continue
        layers.append(ConvLayerSpec(f"conv{i}", "conv", 3, 3, c_in, v, 1, h, w))
        c_in = v
        i += 1
    # fc layers as 1x1 convs on the pooled feature map (HPIPE style);
    # fc0 consumes the 7x7 map directly (VALID 7x7 kernel), so VGG has no
    # GAP node — the five maxpools are its whole pooling topology
    layers.append(ConvLayerSpec("fc0", "fc", 7, 7, 512, 4096, 7, 7, 7))
    layers.append(ConvLayerSpec("fc1", "fc", 1, 1, 4096, 4096, 1, 1, 1))
    layers.append(ConvLayerSpec("fc2", "fc", 1, 1, 4096, 1000, 1, 1, 1))
    return CNNConfig("vgg16", tuple(layers))


def _resnet(depth: int) -> CNNConfig:
    """ResNet-18 (basic blocks) or ResNet-50 (bottleneck blocks)."""
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 7, 7, 3, 64, 2, 224, 224))
    layers.append(_maxpool("maxpool", 64, 112, 112, k=3))
    h = w = 56   # after stem stride-2 and 3x3 maxpool stride-2

    if depth == 18:
        stages = [(64, 2), (128, 2), (256, 2), (512, 2)]
        c_in = 64
        for si, (c, blocks) in enumerate(stages):
            for b in range(blocks):
                stride = 2 if (si > 0 and b == 0) else 1
                if stride == 2:
                    h //= 2
                    w //= 2
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}c0", "conv", 3, 3, c_in, c, stride,
                    h * stride, w * stride))
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}c1", "conv", 3, 3, c, c, 1, h, w))
                if stride == 2 or c_in != c:
                    layers.append(ConvLayerSpec(
                        f"s{si}b{b}ds", "pwconv", 1, 1, c_in, c, stride,
                        h * stride, w * stride))
                c_in = c
        layers.append(_gap(512, 7, 7))
        layers.append(ConvLayerSpec("fc", "fc", 1, 1, 512, 1000, 1, 1, 1))
        return CNNConfig("resnet18", tuple(layers))

    if depth == 50:
        stages = [(64, 256, 3), (128, 512, 4), (256, 1024, 6), (512, 2048, 3)]
        c_in = 64
        for si, (mid, out, blocks) in enumerate(stages):
            for b in range(blocks):
                stride = 2 if (si > 0 and b == 0) else 1
                if stride == 2:
                    h //= 2
                    w //= 2
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}c0", "pwconv", 1, 1, c_in, mid, 1,
                    h * stride, w * stride))
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}c1", "conv", 3, 3, mid, mid, stride,
                    h * stride, w * stride))
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}c2", "pwconv", 1, 1, mid, out, 1, h, w))
                if b == 0:
                    layers.append(ConvLayerSpec(
                        f"s{si}b{b}ds", "pwconv", 1, 1, c_in, out, stride,
                        h * stride, w * stride))
                c_in = out
        layers.append(_gap(2048, 7, 7))
        layers.append(ConvLayerSpec("fc", "fc", 1, 1, 2048, 1000, 1, 1, 1))
        return CNNConfig("resnet50", tuple(layers))

    raise ValueError(f"unsupported resnet depth {depth}")


def _mobilenet_v1() -> CNNConfig:
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, 32, 2, 224, 224))
    h = w = 112
    c_in = 32
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for i, (c, s) in enumerate(plan):
        layers.append(ConvLayerSpec(f"dw{i}", "dwconv", 3, 3, c_in, c_in, s, h, w))
        h, w = h // s, w // s
        layers.append(ConvLayerSpec(f"pw{i}", "pwconv", 1, 1, c_in, c, 1, h, w))
        c_in = c
    layers.append(_gap(1024, 7, 7))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, 1024, 1000, 1, 1, 1))
    return CNNConfig("mobilenetv1", tuple(layers))


def _mobilenet_v2() -> CNNConfig:
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, 32, 2, 224, 224))
    h = w = 112
    c_in = 32
    # (expansion, c_out, n, stride)
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    i = 0
    for t, c, n, s in plan:
        for b in range(n):
            stride = s if b == 0 else 1
            mid = c_in * t
            if t != 1:
                layers.append(ConvLayerSpec(
                    f"ir{i}ex", "pwconv", 1, 1, c_in, mid, 1, h, w))
            layers.append(ConvLayerSpec(
                f"ir{i}dw", "dwconv", 3, 3, mid, mid, stride, h, w))
            h, w = h // stride, w // stride
            layers.append(ConvLayerSpec(
                f"ir{i}pj", "pwconv", 1, 1, mid, c, 1, h, w))
            c_in = c
            i += 1
    layers.append(ConvLayerSpec("head", "pwconv", 1, 1, 320, 1280, 1, 7, 7))
    layers.append(_gap(1280, 7, 7))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, 1280, 1000, 1, 1, 1))
    return CNNConfig("mobilenetv2", tuple(layers))


def _mobilenet_v3() -> CNNConfig:
    """MobileNetV3-Large (SE layers counted as pointwise convs)."""
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, 16, 2, 224, 224))
    h = w = 112
    c_in = 16
    # (k, exp, c_out, stride)
    plan = [(3, 16, 16, 1), (3, 64, 24, 2), (3, 72, 24, 1), (5, 72, 40, 2),
            (5, 120, 40, 1), (5, 120, 40, 1), (3, 240, 80, 2), (3, 200, 80, 1),
            (3, 184, 80, 1), (3, 184, 80, 1), (3, 480, 112, 1),
            (3, 672, 112, 1), (5, 672, 160, 2), (5, 960, 160, 1),
            (5, 960, 160, 1)]
    for i, (k, exp, c, s) in enumerate(plan):
        if exp != c_in:
            layers.append(ConvLayerSpec(
                f"b{i}ex", "pwconv", 1, 1, c_in, exp, 1, h, w))
        layers.append(ConvLayerSpec(f"b{i}dw", "dwconv", k, k, exp, exp, s, h, w))
        h, w = h // s, w // s
        layers.append(ConvLayerSpec(f"b{i}pj", "pwconv", 1, 1, exp, c, 1, h, w))
        c_in = c
    layers.append(ConvLayerSpec("head0", "pwconv", 1, 1, 160, 960, 1, 7, 7))
    layers.append(_gap(960, 7, 7))
    layers.append(ConvLayerSpec("head1", "fc", 1, 1, 960, 1280, 1, 1, 1))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, 1280, 1000, 1, 1, 1))
    return CNNConfig("mobilenetv3", tuple(layers))


def mini_resnet18(hw: int = 32, width: int = 32,
                  stages: int = 2) -> CNNConfig:
    """ResNet-18-topology network sized for *executable* pipeline demos:
    small enough that the Pallas engines run in interpret mode on CPU, yet
    with multi-M20K weight buffers so Eq. 1 scores go positive and
    Algorithm 1 genuinely offloads layers to HBM (the full-size nets would
    take minutes per image under the interpreter).

    Structure mirrors ``_resnet(18)``: stride-1 3x3 stem + an explicit
    3x3/stride-2 maxpool node, ``stages`` stages (up to ResNet-18's four)
    of two basic blocks each, with stride-2 transitions and pwconv
    downsamples, then an explicit GAP node (when the final map is still
    spatial) and an fc head.  ``stages=4`` gives the full four-stage
    pipeline depth at executable scale — the shape the dispatch-overhead
    benchmark uses.
    """
    if not 1 <= stages <= 4:
        raise ValueError("mini_resnet18 supports 1..4 stages")
    if hw % 2:
        # the maxpool node emits ceil(hw/2) rows while this builder
        # floor-halves the next layer's declared in_h — reject odd hw
        # rather than desynchronize the declared graph from execution
        raise ValueError("mini_resnet18: hw must be even (the stem "
                         "maxpool halves the map)")
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, width, 1, hw, hw))
    layers.append(_maxpool("maxpool", width, hw, hw, k=3))
    h = w = hw // 2
    c_in = width
    for si, (c, blocks) in enumerate(
            [(width * 2 ** min(s, 3), 2) for s in range(stages)]):
        for b in range(blocks):
            stride = 2 if (si > 0 and b == 0) else 1
            in_h, in_w = h, w
            if stride == 2:
                if (h > 1 and h % 2) or (w > 1 and w % 2):
                    # an odd map would make this builder's floor-halved
                    # next-layer in_h diverge from the kernels' SAME
                    # output (ceil, == ConvLayerSpec.out_h) — reject
                    # rather than desynchronize the declared graph
                    raise ValueError(
                        f"mini_resnet18: stride-2 transition on an odd "
                        f"{h}x{w} map; pick hw so maps stay even (or 1) "
                        f"through all {stages} stages")
                h, w = max(1, h // 2), max(1, w // 2)   # even or 1x1: exact
            layers.append(ConvLayerSpec(
                f"s{si}b{b}c0", "conv", 3, 3, c_in, c, stride, in_h, in_w))
            layers.append(ConvLayerSpec(
                f"s{si}b{b}c1", "conv", 3, 3, c, c, 1, h, w))
            if stride == 2 or c_in != c:
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}ds", "pwconv", 1, 1, c_in, c, stride,
                    in_h, in_w))
            c_in = c
    if h > 1 or w > 1:
        layers.append(_gap(c_in, h, w))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, c_in, 10, 1, 1, 1))
    return CNNConfig("resnet18-mini", tuple(layers), num_classes=10)


def mini_resnet50(hw: int = 32, width: int = 16,
                  stages: int = 2,
                  blocks_per_stage: int = 1) -> CNNConfig:
    """ResNet-50-topology network (BOTTLENECK blocks: 1x1 -> 3x3 -> 1x1
    with 4x expansion + pwconv downsample) at executable scale — the
    config the bottleneck-fusion differential tests run end to end in
    interpret mode.  One block per stage keeps the pipeline small; the
    block structure (three convs + ds, names ``s{i}b{j}c{0,1,2}`` /
    ``s{i}b{j}ds``) is exactly ``_resnet(50)``'s, so ``residual_blocks``
    groups it identically and ``res_block_int8`` fuses it the same way.

    ``blocks_per_stage > 1`` appends identity bottleneck blocks (no
    downsample, all same-shaped) behind each stage's lead block — the
    full-size net's repeat structure at mini scale, which is what the
    scan-over-blocks compile-scaling benchmark exercises: each stage's
    ``b1..bN`` run compiles as ONE scanned body.
    """
    if not 1 <= stages <= 4:
        raise ValueError("mini_resnet50 supports 1..4 stages")
    if blocks_per_stage < 1:
        raise ValueError("mini_resnet50 needs at least one block per stage")
    if hw % 2:
        raise ValueError("mini_resnet50: hw must be even (the stem "
                         "maxpool halves the map)")
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, width, 1, hw, hw))
    layers.append(_maxpool("maxpool", width, hw, hw, k=3))
    h = w = hw // 2
    c_in = width
    for si in range(stages):
        mid = width * 2 ** min(si, 3)
        out = 4 * mid
        for b in range(blocks_per_stage):
            stride = 2 if (si > 0 and b == 0) else 1
            in_h, in_w = h, w
            if stride == 2:
                if (h > 1 and h % 2) or (w > 1 and w % 2):
                    raise ValueError(
                        f"mini_resnet50: stride-2 transition on an odd "
                        f"{h}x{w} map; pick hw so maps stay even (or 1) "
                        f"through all {stages} stages")
                h, w = max(1, h // 2), max(1, w // 2)
            layers.append(ConvLayerSpec(
                f"s{si}b{b}c0", "pwconv", 1, 1, c_in, mid, 1, in_h, in_w))
            layers.append(ConvLayerSpec(
                f"s{si}b{b}c1", "conv", 3, 3, mid, mid, stride, in_h, in_w))
            layers.append(ConvLayerSpec(
                f"s{si}b{b}c2", "pwconv", 1, 1, mid, out, 1, h, w))
            if b == 0:
                layers.append(ConvLayerSpec(
                    f"s{si}b{b}ds", "pwconv", 1, 1, c_in, out, stride,
                    in_h, in_w))
            c_in = out
    if h > 1 or w > 1:
        layers.append(_gap(c_in, h, w))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, c_in, 10, 1, 1, 1))
    return CNNConfig("resnet50-mini", tuple(layers), num_classes=10)


def mini_mobilenet(hw: int = 8, width: int = 16,
                   blocks: int = 4) -> CNNConfig:
    """MobileNetV1-topology network at executable scale — the config
    that runs ``dwconv_int8`` end to end (compile / run / golden
    placement) in interpret mode.  Structure mirrors
    ``_mobilenet_v1()``: a 3x3 stem (stride 1 at mini scale), then
    ``blocks`` depthwise-separable pairs (``dw{i}`` 3x3 dwconv +
    ``pw{i}`` 1x1 pwconv), stride-2 on every odd-indexed pair with the
    channel count doubling there, then GAP (when the final map is still
    spatial) and an fc head.  No residual adds, so
    ``residual_blocks()`` returns () and every stage cut is legal — the
    partition balancer's no-atomic-units case.
    """
    if blocks < 1:
        raise ValueError("mini_mobilenet needs at least one dw/pw pair")
    layers: List[ConvLayerSpec] = []
    layers.append(ConvLayerSpec("stem", "conv", 3, 3, 3, width, 1, hw, hw))
    h = w = hw
    c_in = width
    for i in range(blocks):
        stride = 2 if i % 2 == 1 else 1
        c_out = c_in * 2 if stride == 2 else c_in
        if stride == 2:
            if (h > 1 and h % 2) or (w > 1 and w % 2):
                # same even-map rule as the mini resnets: a floor-halved
                # odd map would diverge from the kernels' SAME output
                raise ValueError(
                    f"mini_mobilenet: stride-2 pair dw{i} on an odd "
                    f"{h}x{w} map; pick hw so maps stay even (or 1) "
                    f"through all {blocks} pairs")
        layers.append(ConvLayerSpec(
            f"dw{i}", "dwconv", 3, 3, c_in, c_in, stride, h, w))
        if stride == 2:
            h, w = max(1, h // 2), max(1, w // 2)
        layers.append(ConvLayerSpec(
            f"pw{i}", "pwconv", 1, 1, c_in, c_out, 1, h, w))
        c_in = c_out
    if h > 1 or w > 1:
        layers.append(_gap(c_in, h, w))
    layers.append(ConvLayerSpec("fc", "fc", 1, 1, c_in, 10, 1, 1, 1))
    return CNNConfig("mobilenet-mini", tuple(layers), num_classes=10)


CNN_CONFIGS = {
    "resnet18": _resnet(18),
    "resnet50": _resnet(50),
    "vgg16": _vgg16(),
    "mobilenetv1": _mobilenet_v1(),
    "mobilenetv2": _mobilenet_v2(),
    "mobilenetv3": _mobilenet_v3(),
}


def get_cnn(name: str) -> CNNConfig:
    return CNN_CONFIGS[name]
