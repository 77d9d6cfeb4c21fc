"""The port's abstract fused trace (``compiler/pipeline.py::
trace_fused_abstract``, ``count_jaxpr_eqns``) on the CPU.

The JAX package traces its stage-6 program on abstract values and counts
the jaxpr's equations, a scan body once (``tests/test_scan_groups.py``:
the scanned mini ResNet-50 at least 2x smaller than the unrolled one).
The port walks the same dispatchers on ``meta`` tensors and records the
aten ops.  Held: full ResNet-50 and VGG-16 traced with no tensor off
``meta`` (and the engines dispatched equal to the engine table); the
recorded ops of the mini ResNet-50 of the reference's test equal those
of an eager CPU walk of the same net; the counts at their readings.
The port's scan groups are a Python loop, so its scanned and unrolled
counts are equal (``COUNTS``): the reference's 2x does not carry over.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.compiler import (NX2100, compile, count_jaxpr_eqns,
                                  trace_fused_abstract)
from repro_torch.compiler.pipeline import _OpRecorder, walk
from repro_torch.configs.cnn import get_cnn, mini_resnet50
from repro_torch.models.cnn import cnn_input_shape, init_cnn_params

# aten ops recorded at (batch): the same for the scanned and the unrolled
# compile, read on this CPU
COUNTS = {("mini_resnet50", 1): 3586, ("resnet50", 8): 3601,
          ("vgg16", 8): 2300}


def _mini():
    return mini_resnet50(hw=16, width=16, stages=2, blocks_per_stage=10)


def _cfg(name):
    return _mini() if name == "mini_resnet50" else get_cnn(name)


class _OffMeta(TorchDispatchMode):
    """Every tensor an op takes or makes that is not on ``meta``."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.found += [(func.name(), t.device) for t in
                       tree_leaves((args, kwargs or {}, out))
                       if isinstance(t, torch.Tensor)
                       and t.device.type != "meta"]
        return out


@pytest.mark.parametrize("name", ["resnet50", "vgg16"])
def test_full_nets_trace_on_meta_alone(name):
    cp = compile(get_cnn(name), NX2100)
    with _OffMeta() as off:
        trace, seconds = trace_fused_abstract(cp, 8)
    assert off.found == [] and seconds > 0
    assert {s.name: s.kernel for s in trace.stats} == cp.engine_table()
    assert count_jaxpr_eqns(trace) == len(trace.ops) > 0


def test_abstract_ops_equal_an_eager_cpu_walk():
    cfg = _mini()
    cp = compile(cfg, NX2100)
    trace, _ = trace_fused_abstract(cp, 1)
    params = init_cnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randint(-127, 128, cnn_input_shape(cfg, 1),
                      generator=torch.Generator().manual_seed(1),
                      dtype=torch.int8)
    with _OpRecorder() as rec:
        walk(cp, params, x, act_scale=0.05, collect=None)
    assert tuple(rec.ops) == trace.ops


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("name,batch", list(COUNTS))
def test_counts_at_their_readings(name, batch, scan):
    cp = compile(_cfg(name), NX2100, scan=scan)
    assert bool(cp.scan_table()) == (scan and name != "vgg16")
    trace, _ = trace_fused_abstract(cp, batch)
    assert count_jaxpr_eqns(trace) == COUNTS[name, batch]
