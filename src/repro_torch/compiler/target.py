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
  * ``n_pc``/``burst`` HBM pseudo-channels usable and words per read
                       request (§III);
  * ``n_buffers``      double-buffer ring depth of streamed weight paths.

Where the compiled pipeline executes is not part of the target: the
executor takes a ``device`` (``"cuda"`` by default).

Presets
-------
``NX2100``  the paper's Stratix 10 NX2100 at half AI-TB utilization.
``MINI``    an executable-scale budget for the mini networks: small BRAM
            so Algorithm 1 genuinely streams layers of ``mini_resnet18``
            (``tb_budget=500, bram_m20ks=40``, the JAX package's
            ``TPU_INTERPRET`` budgets).

Derive variants with :meth:`Target.replace` (Targets are frozen).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core import bounds, hbm_model

#: The per-engine working-set ceiling the JAX package plans with (16 MiB);
#: kept so both packages place the same layers in the same tiers.
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

    def __post_init__(self):
        for f in ("tb_budget", "bram_m20ks", "vmem_bytes", "n_pc", "burst",
                  "n_buffers"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive")

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

PRESETS = {t.name: t for t in (NX2100, MINI)}


def get_target(name: str) -> Target:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown target {name!r}; presets: {sorted(PRESETS)}") from None
