from repro_torch.kernels.stream_matmul.ops import (  # noqa: F401
    stream_matmul, stream_matmul_requant)
from repro_torch.kernels.stream_matmul.ref import (  # noqa: F401
    stream_matmul_ref)
