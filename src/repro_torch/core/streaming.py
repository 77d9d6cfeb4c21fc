"""Per-tensor weight placement for the LM side — the port of
``repro.core.streaming``: the paper's hybrid memory system (Eq. 1 / Alg. 1)
adapted to a card's memory hierarchy.

Two tiers, two mechanisms:

1. **On-chip pinning** (per device): a pinned tensor's weights stay
   resident in on-chip memory across the tiles of the streamed-matmul
   kernel (fetched once per batch), while a streamed tensor's weights are
   re-read from HBM on every use.  The analogue of keeping a weight
   buffer in M20Ks vs HBM.  On the H100 the resident capacity that the
   streamed matmul's pinned mode can use is its shared memory: 228 KiB an
   SM, 132 SMs (``roofline/hw.py``; the JAX package budgets a TPU core's
   VMEM).  ``plan_vmem_residency`` keeps its reference name.

2. **DP-shard streaming** (across devices): a *replicated* tensor costs
   HBM capacity on every device but is instantly available; a
   *dp-streamed* tensor is sharded over the ``data`` axis (1/dp of the
   bytes per device) and all-gathered right before use — the
   distribution-level analogue of HBM offload, with the interconnect
   playing the pseudo-channel.  Budget: per-device HBM capacity (what must
   fit) and per-step gather bytes (what keeps the step time).

Both planners are the same greedy: score tensors by (capacity saved) /
(bandwidth required) — Eq. 1 — and move the best scorers until the budget
constraint is met, mirroring Algorithm 1.

Params are trees of tensors (``meta`` tensors for a dry run, see
``models.transformer.abstract_params``), specs trees of ``P``.  Leaves
are visited as ``jax.tree_util.tree_flatten_with_path`` visits them —
dict keys sorted, list and tuple entries in order — and named as
``jax.tree_util.keystr`` names them (``['layers']['attn']['wq']``,
``[3]`` for an index): the stable sort of ``plan_placement`` breaks ties
in that order, so the decisions equal the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (P, axis_size, flatten_with_paths,
                                       map_with_paths)
from repro_torch.roofline import hw

VMEM_BYTES = hw.SMEM_BYTES_TOTAL
HBM_BYTES = hw.HBM_BYTES


@dataclass
class TensorPlacement:
    path: str
    bytes: int                     # total logical bytes (per model copy)
    uses_per_step: float           # fraction of steps this tensor is read
    decision: str = "replicated"   # replicated | dp_streamed
    vmem_pinned: bool = False

    @property
    def score(self) -> float:
        """Eq. 1 analogue: per-device capacity saved per unit of gather
        bandwidth.  Rarely-used big tensors (routed experts) score highest;
        hot small tensors (norms, router) lowest."""
        if self.uses_per_step <= 0:
            return float("inf")
        return 1.0 / self.uses_per_step


@dataclass
class PlacementPlan:
    tensors: List[TensorPlacement]
    dp: int
    hbm_per_device: int
    notes: str = ""

    def bytes_per_device(self) -> int:
        total = 0
        for t in self.tensors:
            model_sharded = t.bytes            # already divided by model ax
            total += model_sharded // self.dp if t.decision == "dp_streamed" \
                else model_sharded
        return total

    def gather_bytes_per_step(self) -> float:
        return sum(t.bytes * t.uses_per_step * (self.dp - 1) / self.dp
                   for t in self.tensors if t.decision == "dp_streamed")

    def streamed(self) -> List[TensorPlacement]:
        return [t for t in self.tensors if t.decision == "dp_streamed"]


def _nbytes(leaf) -> int:
    if not hasattr(leaf, "dtype"):
        return 0
    return leaf.numel() * leaf.element_size()


def tensor_uses_per_step(path: str, cfg: ArchConfig) -> float:
    """How often (per decode step / per microbatch) a tensor is read.
    Routed expert weights are read with probability ~top_k/n_experts per
    token — the paper's ideal HBM candidates (big, low bandwidth)."""
    if cfg.moe is not None and "ffn" in path and (
            "w_gate" in path or "w_up" in path or "w_down" in path) \
            and "shared" not in path:
        return min(1.0, cfg.moe.top_k / cfg.moe.n_experts * 8)
        # x8: batches >1 token hit several experts; bounded by 1
    return 1.0


def model_sharded_bytes(leaf, spec: Optional[P]) -> int:
    """Bytes of one leaf after model-axis sharding (what replication would
    cost per device before any dp-streaming)."""
    n = _nbytes(leaf)
    if spec is not None:
        for ax in spec:
            if ax is not None:
                n //= axis_size(ax)
    return n


def plan_placement(params, specs, cfg: ArchConfig, *,
                   hbm_per_device: int = HBM_BYTES,
                   reserve_bytes: int = 6 * 2**30,
                   dp: Optional[int] = None) -> PlacementPlan:
    """Algorithm 1 on LM weights: dp-stream the best-scoring tensors until
    the replicated remainder fits per-device HBM (minus a reserve for
    activations / KV cache / optimizer shards)."""
    dp = dp or max(axis_size(("pod", "data")), 1)
    leaves = flatten_with_paths(params)
    spec_leaves = [s for _, s in flatten_with_paths(specs)] \
        if specs is not None else [None] * len(leaves)
    tensors = [TensorPlacement(path=path,
                               bytes=model_sharded_bytes(leaf, spec),
                               uses_per_step=tensor_uses_per_step(path, cfg))
               for (path, leaf), spec in zip(leaves, spec_leaves)]
    plan = PlacementPlan(tensors=tensors, dp=dp,
                         hbm_per_device=hbm_per_device)
    budget = hbm_per_device - reserve_bytes
    if dp <= 1:
        plan.notes = "dp=1: streaming impossible, all replicated"
        return plan
    order = sorted(range(len(tensors)),
                   key=lambda i: (tensors[i].score, tensors[i].bytes),
                   reverse=True)
    for i in order:
        if plan.bytes_per_device() <= budget:
            break
        # streaming a tiny tensor saves nothing — skip the long tail
        if tensors[i].bytes < 2**20:
            continue
        tensors[i].decision = "dp_streamed"
    plan.notes = (f"replicated={sum(t.decision=='replicated' for t in tensors)}"
                  f" dp_streamed={len(plan.streamed())}"
                  f" bytes/dev={plan.bytes_per_device()/2**30:.2f} GiB")
    return plan


def plan_vmem_residency(params, cfg: ArchConfig, *,
                        vmem_budget: int = VMEM_BYTES // 2
                        ) -> Dict[str, bool]:
    """Per-device tier: choose which tensors the streamed-matmul kernel
    keeps resident on chip (its pinned mode).  All weights are read once
    per step, so capacity saved / bandwidth is uniform — the knapsack then
    prefers packing the largest total, i.e. greedy by size descending
    (ties to Eq. 1: every pinned byte saves exactly one HBM byte per
    step).  The default budget is half the card's shared memory."""
    order = sorted(flatten_with_paths(params), key=lambda kv: _nbytes(kv[1]),
                   reverse=True)
    pinned: Dict[str, bool] = {}
    used = 0
    for path, leaf in order:
        nbytes = _nbytes(leaf)
        take = used + nbytes <= vmem_budget
        pinned[path] = take
        if take:
            used += nbytes
    return pinned


def apply_plan_to_specs(specs, plan: PlacementPlan, params):
    """Rewrite the spec tree: dp-streamed tensors get their first
    shardable (currently-unsharded, divisible) dim sharded over ``data``.
    A partitioner would then gather each at its use site — the 'prefetch'
    overlapped with compute, as the paper's FIFOs do.

    Divisibility is checked against the actual leaf shapes; a tensor with
    no evenly-divisible free dim keeps its replicated placement (recorded
    back into the plan)."""
    streamed_paths = {t.path for t in plan.streamed()}
    data_size = axis_size("data")
    shapes = {path: tuple(leaf.shape)
              for path, leaf in flatten_with_paths(params)}
    placed = {t.path: t for t in plan.tensors}

    def rewrite(path, spec):
        if path not in streamed_paths or not isinstance(spec, P):
            return spec
        shape = shapes.get(path, ())
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used_axes = {a for p in parts if p is not None
                     for a in (p if isinstance(p, tuple) else (p,))}
        for d in range(len(parts)):
            if parts[d] is None and "data" not in used_axes and \
                    d < len(shape) and shape[d] % max(data_size, 1) == 0 \
                    and data_size > 1:
                parts[d] = "data"
                break
        else:
            placed[path].decision = "replicated"   # could not shard
        return P(*parts)

    return map_with_paths(rewrite, specs)
