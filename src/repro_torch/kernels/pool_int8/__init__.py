from repro_torch.kernels.pool_int8.ops import (  # noqa: F401
    global_avgpool_int8, maxpool_int8)
from repro_torch.kernels.pool_int8.ref import (  # noqa: F401
    global_avgpool_int8_ref, maxpool_int8_ref)
