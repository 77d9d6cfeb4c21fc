"""H2PIPE on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.

The compiler (placement, FIFO sizing, engine binding) is a copy of the
JAX package's framework-free planning code; the layer engines run
hand-written CUDA kernels for ``sm_90a`` (``kernels/csrc``) on CUDA
tensors and their plain PyTorch versions on CPU tensors.  Activations are
NHWC int8 and weights HWIO int8 at every public function, as in ``repro``.
"""
