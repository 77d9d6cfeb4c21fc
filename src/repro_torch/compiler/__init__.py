"""The H2PIPE compiler on PyTorch.

  * :func:`compile` — ``compile(cfg, target) -> CompiledPipeline``: the
    staged flow (parallelism -> Alg. 1 placement -> FIFO sizing -> engine
    binding -> working-set validation);
  * :class:`Target` + presets :data:`NX2100` / :data:`MINI` /
    :data:`H100` (NX2100's budgets, each layer checked against the CUDA
    launch plan the card runs);
  * :func:`register_engine` / :class:`LayerEngine` — the pluggable
    per-layer kernel registry;
  * :class:`CompiledPipeline` — ``engine_table()``, ``block_table()``,
    ``scan_table()``, ``vmem_report()``, ``run()`` (on the card unless
    ``device="cpu"``), ``stats_template()`` / ``eq2_report().verify()``,
    ``serve()``; :func:`trace_fused` (stage 6, a :class:`FusedTrace`)
    and :func:`trace_fused_abstract` (the stage-6 forward walked on
    ``meta`` tensors, its aten ops recorded; :func:`count_jaxpr_eqns`
    counts them);
  * :func:`partition_pipeline` / :class:`StagePartition` — the sharding
    stage (``CompiledPipeline.partition(n_stages)``): contiguous stage
    programs balanced by the cycle model, fused residual blocks atomic,
    with per-stage Eq. 2 accounting and ``verify_eq2()``;
    ``serve_sharded(params, mesh=...)`` serves them as a stage ring;
  * :func:`autotune_plan` / :class:`AutotuneConfig` — the search-based
    placement + FIFO co-optimizer (``compile(cfg, target,
    autotune=...)`` is the integrated path), seeded by the greedy Alg. 1
    plan, never worse than the seed and deterministic per seed.

The JAX package's ``TPU_INTERPRET`` preset is not here, by design: the
port has no interpret mode (its kernels run on the card, their plain
versions on the CPU and ``meta``).
"""
from repro_torch.compiler.autotune import (AutotuneConfig,  # noqa: F401
                                           AutotuneError, AutotuneResult,
                                           Candidate, Evaluation,
                                           autotune_plan,
                                           solve_serving_credits)
from repro_torch.compiler.engines import (EngineContext,  # noqa: F401
                                          LayerEngine, LayerExecStats,
                                          get_engine, register_engine,
                                          registered_engines,
                                          select_block_engine,
                                          select_engine, select_scan_engine,
                                          select_stem_engine,
                                          unregister_engine)
from repro_torch.compiler.partition import (PartitionError,  # noqa: F401
                                            StagePartition, StageProgram,
                                            partition_pipeline,
                                            stage_forward_fns)
from repro_torch.compiler.pipeline import (BlockAssignment,  # noqa: F401
                                           CompileError, CompiledPipeline,
                                           EngineAssignment,
                                           Eq2MismatchError, ExecutionReport,
                                           FusedTrace, ScanGroupAssignment,
                                           TargetBudgetError, compile,
                                           count_jaxpr_eqns, finalize,
                                           make_dispatchers, plan_pipeline,
                                           trace_fused, trace_fused_abstract)
from repro_torch.compiler.target import (DEFAULT_VMEM_BYTES,  # noqa: F401
                                         H100, MINI, NX2100, PRESETS,
                                         Target, get_target)
