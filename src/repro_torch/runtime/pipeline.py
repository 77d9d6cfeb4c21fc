"""Layer-pipelined CNN inference executor — the running H2PIPE system.

``repro_torch.compiler.compile(cfg, target)`` decides, per layer (or per
fused residual block), which registered
:class:`~repro_torch.compiler.engines.LayerEngine` runs it and whether
its weights are pinned on chip or stream from HBM; this module executes
a CNN under that :class:`CompiledPipeline`.

Only the eager walk exists: ``models.cnn.cnn_forward`` offers every node
to the ``engine``/``block_engine``/``scan_engine`` hooks and each engine
launches its CUDA kernels from Python.  ``backend="fused"`` (one captured
program per input shape in the JAX package) raises until it has a CUDA
graph counterpart.

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

from repro_torch.compiler.engines import EngineContext, LayerExecStats
from repro_torch.compiler.pipeline import (CompiledPipeline, ExecutionReport,
                                           finalize, make_dispatchers)
from repro_torch.core.schedule import PipelinePlan
from repro_torch.models.cnn import cnn_forward, init_cnn_params

__all__ = ["PipelineExecutor", "ExecutionReport", "LayerExecStats",
           "execute_cnn"]

Params = Dict[str, Dict[str, torch.Tensor]]

BACKENDS = ("eager",)


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
    fly, without target budget enforcement."""

    def __init__(self, compiled: Union[CompiledPipeline, PipelinePlan], *,
                 device="cuda", act_scale: float = 0.05,
                 backend: str = "eager"):
        if isinstance(compiled, PipelinePlan):
            compiled = finalize(compiled, target=None)
        if backend == "fused":
            raise NotImplementedError(
                "backend='fused' has no CUDA-graph counterpart yet; "
                "use backend='eager'")
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
        ctx = EngineContext(act_scale=self.act_scale)
        dispatch, block_dispatch, scan_dispatch = make_dispatchers(
            self.compiled, ctx, report.layers)
        logits = cnn_forward(params, self.plan.cfg, images, engine=dispatch,
                             block_engine=block_dispatch,
                             scan_engine=scan_dispatch)
        return logits, report

    def __call__(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        return self.run(params, images)[0]


def execute_cnn(plan: Union[CompiledPipeline, PipelinePlan], params: Params,
                images: torch.Tensor, *, device="cuda",
                backend: str = "eager"
                ) -> Tuple[torch.Tensor, ExecutionReport]:
    """One-shot convenience: run ``images`` through ``plan``."""
    return PipelineExecutor(plan, device=device,
                            backend=backend).run(params, images)
