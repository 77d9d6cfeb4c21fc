"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<sha>.so
         csrc/<name>.cu

``<sha>`` is the hash of the source, so an edited source rebuilds and a
stale library is never loaded.  A variant (``VARIANTS``) is a source
built a second time with defines of its own into a library of its own
name: the flash-attention kernels' f16 instances, built beside the bf16
ones by a second nvcc at once.  The compiler's report (``-Xptxas -v``:
each kernel's registers, stack and spills) is kept beside the library
(:func:`build_log`).  Only the sources in this package are
built.  ``--use_fast_math`` is deliberately absent: the fused requant
epilogues rely on IEEE division and round-half-even, and the attention
kernels on accurate ``logf``/``tanhf``, IEEE division and, but for the
forward's ``wgmma`` route (``exp2f`` with the scale folded in, held to
the same limits), accurate ``expf``.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Hashable, NamedTuple, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: library name -> (source under ``csrc/``, extra nvcc flags) for the
#: libraries built from another library's source
VARIANTS = {
    "flash_attention_f16": ("flash_attention", ("-DH2PIPE_HALF",)),
    "flash_attention_bwd_f16": ("flash_attention_bwd", ("-DH2PIPE_HALF",)),
}
SOURCES = ("conv2d_int8", "dwconv_int8", "flash_attention",
           "flash_attention_bwd", "pool_int8", "stream_matmul") + \
    tuple(VARIANTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

#: Launches per kernel since the last :func:`reset_launches`.  Each wrapper
#: adds one where it launches its kernel, and nowhere else; a CUDA graph's
#: replay adds the launches its capture recorded (:func:`count_replay`).
LAUNCHES: Dict[str, int] = {}
#: The same launches by ``(kernel, shape)``, for the wrappers that name
#: the shape (or the instance) they launch
#: (``count_launch(kernel, shape)``).
SHAPE_LAUNCHES: Dict[Tuple[str, Hashable], int] = {}
# the active cost counters (``roofline/op_cost.py``): each launch's charge
# goes to every one of them
_charge_sinks: list = []
_count_lock = threading.Lock()
# the launches a thread records into a CUDA graph being captured: capture
# records kernels without running them, so they count at each replay
_capture = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source a library is built from and its extra nvcc flags."""
    src, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{src}.cu", flags


def library_path(name: str) -> Path:
    """Where the library ``name`` lives: named by the hash of its source,
    of the shared headers it includes and of its extra flags."""
    src, flags = _source(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """What nvcc reported (``-Xptxas -v``) when it built the library
    ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str):
    """Start nvcc for one source into a temporary file; None when the
    library for this source hash and its build log are already there."""
    out = library_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    src, flags = _source(name)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", tmp,
           str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)        # atomic: concurrent builders never see half


def build_all(names: Sequence[str] = SOURCES) -> None:
    """Compile every listed source that is not built yet, one nvcc
    process per source, all started together."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu``, or a variant's
    source), built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


class Charge(NamedTuple):
    """What one launch charges to the cost counter
    (``roofline/op_cost.py``), which cannot see a launch through ctypes.
    Each ``ops.py`` computes its kernels' charges from the launch's
    shapes alone, by the reference's rule for a ``pl.pallas_call``
    (``repro/roofline/jaxpr_cost.py``): the bytes are the operands plus
    the results (scratch never round-trips HBM), the FLOPs the kernel
    body's, counted per jaxpr equation as the reference counts them,
    times the grid (a ``pl.when`` counts its branch at every grid step).
    The body counts are those of the JAX package's bodies (K1-K11), held
    on the CPU against ``jaxpr_cost.cost_of`` of the JAX call."""
    flops: int
    bytes: int
    matmul_flops: int          # the dots of the body, times the grid


def count_launch(kernel: str, shape: Optional[Hashable] = None,
                 cost: Optional[tuple] = None) -> None:
    """One launch of ``kernel``; with ``shape`` (or the instance it
    launched), also one of ``(kernel, shape)`` in :data:`SHAPE_LAUNCHES`;
    with ``cost`` (``(flops, bytes, matmul_flops)``), its charge to the
    active cost counters."""
    counts = dict.fromkeys((kernel,) if shape is None
                           else (kernel, (kernel, shape)), 1)
    sink = getattr(_capture, "sink", None)
    if sink is None:
        count_replay(Recorded(counts, cost))
    else:
        sink.add(Recorded(counts, cost))


@dataclasses.dataclass
class Recorded:
    """What a captured CUDA graph launches at each replay: ``counts`` (a
    kernel's name or a ``(kernel, shape)`` pair -> launches) and
    ``charge``, the ``(flops, bytes, matmul_flops)`` those launches charge
    to a cost counter, or None."""
    counts: Dict = dataclasses.field(default_factory=dict)
    charge: Optional[tuple] = None

    def add(self, other: "Recorded") -> None:
        for key, n in other.counts.items():
            self.counts[key] = self.counts.get(key, 0) + n
        if other.charge is not None:
            self.charge = tuple(other.charge) if self.charge is None \
                else tuple(a + b for a, b in zip(self.charge, other.charge))


def add_charge_sink(fn) -> None:
    """``fn(flops, nbytes, matmul_flops)`` receives each launch's charge
    until :func:`remove_charge_sink`."""
    with _count_lock:
        _charge_sinks.append(fn)


def remove_charge_sink(fn) -> None:
    with _count_lock:
        _charge_sinks.remove(fn)


def charge(cost: tuple) -> None:
    """Charge ``(flops, bytes, matmul_flops)`` to the active counters
    without counting a launch (a wrapper given ``meta`` tensors)."""
    with _count_lock:
        sinks = list(_charge_sinks)
    for fn in sinks:
        fn(*cost)


@contextlib.contextmanager
def capturing_launches():
    """While a CUDA graph is captured on this thread: the launches its
    wrappers make go into the yielded :class:`Recorded`, not into
    :data:`LAUNCHES`."""
    sink = Recorded()
    _capture.sink = sink
    try:
        yield sink
    finally:
        _capture.sink = None


def count_replay(recorded: Recorded) -> None:
    """One replay of a captured graph: its recorded launches count (a
    kernel's name into :data:`LAUNCHES`, a ``(kernel, shape)`` pair into
    :data:`SHAPE_LAUNCHES`) and their recorded charge goes to the active
    cost counters."""
    with _count_lock:
        for key, n in recorded.counts.items():
            into = LAUNCHES if isinstance(key, str) else SHAPE_LAUNCHES
            into[key] = into.get(key, 0) + n
    if recorded.charge is not None:
        charge(recorded.charge)


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()
        SHAPE_LAUNCHES.clear()


def runs_plain(x, *, meta_launches: bool = False) -> bool:
    """Whether a wrapper given ``x`` runs its plain version: CPU tensors
    do, CUDA tensors launch the kernel.  ``meta`` tensors (a dry run's
    shapes without data) run the plain version, or where the wrapper
    passes ``meta_launches`` its launch path, which on ``meta`` charges
    the kernel's cost and allocates its outputs but launches nothing.
    Any other device is refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    if x.device.type == "meta":
        return not meta_launches
    raise ValueError(f"unsupported device {x.device}: the kernels run on "
                     f"cuda, their plain versions on cpu (and meta)")


def check_cuda_tensor(t, name: str, dtype, device) -> None:
    """What every kernel wrapper asks of its tensor arguments."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
