"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<sha>.so csrc/<name>.cu

``<sha>`` is the hash of the source, so an edited source rebuilds and a
stale library is never loaded.  Only the sources in this package are
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
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("conv2d_int8", "dwconv_int8", "flash_attention",
           "flash_attention_bwd", "pool_int8", "stream_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

#: Launches per kernel since the last :func:`reset_launches`.  Each wrapper
#: adds one where it launches its kernel, and nowhere else; a CUDA graph's
#: replay adds the launches its capture recorded (:func:`count_replay`).
LAUNCHES: Dict[str, int] = {}
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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by the hash of
    the source and of the shared headers it includes."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None when the
    library for this source hash is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
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
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
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
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def count_launch(kernel: str) -> None:
    sink = getattr(_capture, "sink", None)
    if sink is not None:
        sink[kernel] = sink.get(kernel, 0) + 1
        return
    with _count_lock:
        LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


@contextlib.contextmanager
def capturing_launches():
    """While a CUDA graph is captured on this thread: the launches its
    wrappers make go into the yielded dict, not into :data:`LAUNCHES`."""
    sink: Dict[str, int] = {}
    _capture.sink = sink
    try:
        yield sink
    finally:
        _capture.sink = None


def count_replay(launches: Dict[str, int]) -> None:
    """One replay of a captured graph: its recorded launches count."""
    with _count_lock:
        for kernel, n in launches.items():
            LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + n


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def runs_plain(x) -> bool:
    """Whether a wrapper given ``x`` runs its plain version: CPU tensors
    do, CUDA tensors launch the kernel, anything else is refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {x.device}")


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
