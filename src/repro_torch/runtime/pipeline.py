"""Layer-pipelined CNN inference executor — the running H2PIPE system.

``repro_torch.compiler.compile(cfg, target)`` decides, per layer (or per
fused residual block), which registered
:class:`~repro_torch.compiler.engines.LayerEngine` runs it and whether
its weights are pinned on chip or stream from HBM; this module executes
a CNN under that :class:`CompiledPipeline`.

Two backends:

``backend="fused"`` (default)
    The stage-6 path: on the card the whole engine table is walked over
    ``models.cnn.cnn_forward`` once and captured into ONE CUDA graph per
    (input shape, dtype, params), so a warm ``run()`` is a single graph
    replay.  Traces are cached on the ``CompiledPipeline`` (shared across
    executors and threads, bounded LRU); each run's report is the
    capture's stats template.  On the CPU the trace is the eager walk.

``backend="eager"``
    The per-layer walk: ``cnn_forward`` offers every node to the
    ``engine``/``block_engine``/``scan_engine`` hooks and each engine
    launches its CUDA kernels from Python.  Bit-identical to the fused
    path.

Device: the executor runs on the card (``device="cuda"``) unless the
caller asks for the CPU, where every engine runs its kernel's plain
version.  With no card a CUDA executor raises; nothing falls back.

The report cross-checks the executed Eq. 2 words (from the engines'
:class:`LayerExecStats`) against the plan's analytic words
(``report.verify()``).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.compiler.engines import LayerExecStats
from repro_torch.compiler.pipeline import (CompiledPipeline, ExecutionReport,
                                           finalize, walk)
from repro_torch.core.schedule import PipelinePlan
from repro_torch.models.cnn import init_cnn_params

__all__ = ["PipelineExecutor", "ExecutionReport", "LayerExecStats",
           "execute_cnn"]

Params = Dict[str, Dict[str, torch.Tensor]]

BACKENDS = ("fused", "eager")


def resolve_device(device) -> torch.device:
    """The executor's device; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class PipelineExecutor:
    """Executes a CNN end-to-end under a :class:`CompiledPipeline`.

    A bare :class:`PipelinePlan` is accepted and gets engines bound on the
    fly, without target budget enforcement.

    ``backend`` picks the execution strategy: ``"fused"`` (one CUDA graph
    per input shape, cached on the compiled pipeline) or ``"eager"`` (the
    per-layer dispatch walk) — bit-identical by contract."""

    def __init__(self, compiled: Union[CompiledPipeline, PipelinePlan], *,
                 device="cuda", act_scale: float = 0.05,
                 backend: str = "fused"):
        if isinstance(compiled, PipelinePlan):
            compiled = finalize(compiled, target=None)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        self.compiled = compiled
        self.device = resolve_device(device)
        self.act_scale = act_scale
        self.backend = backend

    @property
    def plan(self) -> PipelinePlan:
        return self.compiled.plan

    def init_params(self, generator: torch.Generator) -> Params:
        return init_cnn_params(self.plan.cfg, generator, self.device)

    def run(self, params: Params, images: torch.Tensor
            ) -> Tuple[torch.Tensor, ExecutionReport]:
        """images: [B,H,W,C] int8 on the executor's device ->
        (logits [B,classes], report)."""
        if images.device.type != self.device.type:
            raise ValueError(f"images on {images.device}, executor on "
                             f"{self.device}")
        report = ExecutionReport(plan=self.plan, images=int(images.shape[0]),
                                 block_assignments=self.compiled
                                 .block_assignments,
                                 scan_assignments=self.compiled
                                 .scan_assignments)
        if self.backend == "fused":
            trace, logits = self.compiled.fused_trace_and_first(
                params, images, self.act_scale)
            if logits is None:
                logits = trace.fn(params, images)
            report.layers.extend(trace.stats)     # the capture's template
            return logits, report
        logits = walk(self.compiled, params, images, act_scale=self.act_scale,
                      collect=report.layers)
        return logits, report

    def __call__(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return self.run(params, images)[0]


def execute_cnn(plan: Union[CompiledPipeline, PipelinePlan], params: Params,
                images: torch.Tensor, *, device="cuda",
                backend: str = "fused"
                ) -> Tuple[torch.Tensor, ExecutionReport]:
    """One-shot convenience: run ``images`` through ``plan``."""
    return PipelineExecutor(plan, device=device,
                            backend=backend).run(params, images)
