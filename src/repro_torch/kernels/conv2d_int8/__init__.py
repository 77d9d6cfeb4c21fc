from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,  # noqa: F401
                                                 conv2d_int8_requant)
from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref  # noqa: F401
