"""Target descriptors — the resource envelope ``compile()`` plans against.

H2PIPE is a compiler: the same CNN maps to different hardware depending on
how many tensor blocks, how much on-chip RAM, and how many HBM
pseudo-channels the device offers.  A :class:`Target` makes that envelope
an explicit, immutable value:

  * ``tb_budget``      AI tensor blocks the parallelism allocator may spend
                       (the HPIPE balancing pass, §II-B);
  * ``bram_m20ks``     on-chip weight/activation RAM in M20K blocks — the
                       budget Algorithm 1's hybrid selection fills (§V-B);
  * ``vmem_bytes``     per-layer-engine working-set ceiling in bytes (one
                       engine's M20K slice); ``compile()`` re-places or
                       rejects layers whose chosen engine exceeds it;
  * ``smem_bytes``     when set, the card's per-block opt-in shared
                       memory: stage 5 then holds each binding's CUDA
                       launch plan to it in place of the working set
                       (``None``: the working-set check);
  * ``n_pc``/``burst`` HBM pseudo-channels usable and words per read
                       request (§III);
  * ``n_buffers``      double-buffer ring depth of streamed weight paths.

Where the compiled pipeline executes is not part of the target: the
executor takes a ``device`` (``"cuda"`` by default).

Presets
-------
``NX2100``  the paper's Stratix 10 NX2100 at half AI-TB utilization.
``H100``    NX2100's planning budgets (so Algorithm 1 picks the paper's
            tiers), with stage 5 checking each layer against the launch
            plan the H100 runs: its shared-memory bytes within
            ``MAX_SMEM_BYTES`` (232,448 B a block), or no plan at all.
``MINI``    an executable-scale budget for the mini networks: small BRAM
            so Algorithm 1 genuinely streams layers of ``mini_resnet18``
            (``tb_budget=500, bram_m20ks=40``, the JAX package's
            ``TPU_INTERPRET`` budgets).

Derive variants with :meth:`Target.replace` (Targets are frozen).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core import bounds, hbm_model
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES

#: The JAX package's per-engine working-set ceiling (16 MiB, the VMEM of
#: the TPUs it runs on), checked against the Pallas blocks' working sets.
#: It is kept for ``NX2100`` and ``MINI`` only, so that both packages
#: compile those targets to the same tables; it is never the card's: the
#: ``H100`` target checks the CUDA launch plans against the card's
#: ``MAX_SMEM_BYTES``.
DEFAULT_VMEM_BYTES = 16 * 1024 * 1024


@dataclass(frozen=True)
class Target:
    """Immutable resource descriptor one pipeline is compiled against."""

    name: str
    tb_budget: int                     # AI tensor blocks for parallelism
    bram_m20ks: int                    # on-chip RAM budget (M20K blocks)
    vmem_bytes: int = DEFAULT_VMEM_BYTES   # per-engine working-set ceiling
    n_pc: int = hbm_model.USABLE_PCS   # usable HBM pseudo-channels
    burst: int = 8                     # HBM words per read request
    n_buffers: int = 2                 # streamed-weight ring depth
    smem_bytes: Optional[int] = None   # launch-plan check's ceiling

    def __post_init__(self):
        for f in ("tb_budget", "bram_m20ks", "vmem_bytes", "n_pc", "burst",
                  "n_buffers"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")
        if self.smem_bytes is not None and self.smem_bytes <= 0:
            raise ValueError("smem_bytes must be positive")

    @property
    def checks_plans(self) -> bool:
        """Whether stage 5 checks the CUDA launch plans (else the working
        sets)."""
        return self.smem_bytes is not None

    def claim(self, engine, spec, scheds) -> Optional[int]:
        """What one binding (a layer, or a unit with its member
        schedules) claims under this target's check: the engine's
        ``plan_bytes`` where the target checks plans (``None`` where the
        card has no plan for it), else its ``vmem_bytes``."""
        if self.checks_plans:
            return engine.plan_bytes(spec, scheds)
        return engine.vmem_bytes(spec, scheds)

    def fits(self, claim: Optional[int]) -> bool:
        """Whether a claim passes: a plan (or working set) within
        ``smem_bytes`` where set, else within ``vmem_bytes``."""
        limit = self.vmem_bytes if self.smem_bytes is None \
            else self.smem_bytes
        return claim is not None and claim <= limit

    @property
    def chain_budget(self) -> int:
        """HBM bandwidth pool in 80-bit tensor-chain feeds (Alg. 1 units)."""
        from repro_torch.core.placement import CHAINS_PER_PC
        return self.n_pc * CHAINS_PER_PC

    def replace(self, **changes) -> "Target":
        """``dataclasses.replace`` convenience; renames the variant unless
        the caller overrides ``name`` too."""
        if "name" not in changes:
            changes["name"] = self.name + "*"
        return dataclasses.replace(self, **changes)


#: The paper's device: Stratix 10 NX2100 at half AI-TB utilization, full
#: M20K budget, 31 usable pseudo-channels, burst 8 (§VI defaults).
NX2100 = Target(
    name="nx2100",
    tb_budget=bounds.NX2100_TENSOR_BLOCKS // 2,
    bram_m20ks=bounds.NX2100_M20KS,
)

#: Executable scale for the mini networks: BRAM small enough that
#: Algorithm 1 streams several layers of ``mini_resnet18``.
MINI = Target(
    name="mini",
    tb_budget=500,
    bram_m20ks=40,
)

#: The card the port runs on: NX2100's budgets, so Algorithm 1 and the
#: FIFO sizing are the paper's, and a stage-5 check against the launch
#: plans the H100 runs (``compiler/engines.py``'s ``plan_bytes``).
H100 = NX2100.replace(name="h100", smem_bytes=MAX_SMEM_BYTES)

PRESETS = {t.name: t for t in (NX2100, MINI, H100)}


def get_target(name: str) -> Target:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; presets: {sorted(PRESETS)}") from None
