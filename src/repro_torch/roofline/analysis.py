"""Three-term roofline of one dry-run cell — the port of
``repro.roofline.analysis`` over the H100's constants (``hw``):

    compute term    = FLOPs / (chips x bf16 tensor-core peak)
    memory term     = bytes / (chips x HBM bandwidth)
    collective term = collective bytes / (links x link bandwidth)

FLOPs and bytes are the step's global count (``op_cost``).  The
collective bytes are per device: the reference reads them from XLA's
post-SPMD HLO text (``collective_bytes``, ``hlo_loops.
scaled_collective_bytes``), the port charges them while it counts the
step on the mesh (``roofline/collectives.py``), every execution of a
layer's collectives, as the reference's loop-scaled count does.  A
one-device mesh has none.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.roofline import collectives, hw

@dataclass
class Roofline:
    """``hlo_flops`` / ``hlo_bytes`` keep the reference's names: the
    global count of the step (here from the aten ops and the kernels'
    charges, not from a jaxpr); ``coll_bytes`` is per device, every
    execution counted; ``coll_detail`` its split by kind under the
    reference's keys.  ``model_flops`` is the global 6·N·D (train) /
    2·N·D (inference) figure."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    coll_detail: Dict[str, object] = field(default_factory=dict)
    bytes_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * hw.PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * hw.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (hw.ICI_BW_PER_LINK * hw.ICI_LINKS)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Step time lower bound if the dominant term fully overlaps the
        others (the roofline)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        useful (catches remat recompute and dispatch waste)."""
        if not self.hlo_flops:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def mfu_at_bound(self) -> float:
        """Model FLOPs utilization IF the program ran exactly at the
        dominant-term bound."""
        if not self.t_bound:
            return 0.0
        return (self.model_flops / self.chips) / (
            self.t_bound * hw.PEAK_FLOPS_BF16)

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_frac": self.useful_fraction,
            "mfu_at_bound": self.mfu_at_bound,
            "bytes_per_device": self.bytes_per_device,
        }


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, global_flops: float, global_bytes: float,
            bytes_per_device: Optional[float] = None,
            coll_detail: Optional[Dict[str, int]] = None) -> Roofline:
    """A Roofline from a cell's count: ``coll_detail`` its collectives a
    device by the reference's keys (``collectives.detail``, with
    ``naive_module_sum``), whose bytes make the collective term; without
    it the term is 0 (a one-device mesh)."""
    detail = {kind: 0 for kind in collectives.KINDS}
    detail.update(count=0, naive_module_sum=0)
    detail.update(coll_detail or {})
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=float(global_flops),
                    hlo_bytes=float(global_bytes),
                    coll_bytes=float(sum(detail[kind]
                                         for kind in collectives.KINDS)),
                    model_flops=float(model_flops), coll_detail=detail,
                    bytes_per_device=bytes_per_device)
