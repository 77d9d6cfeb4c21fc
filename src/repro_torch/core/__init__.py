# The paper's planning passes (placement, FIFO sizing, fifo_sim) and the
# schedule data model; the staged compile() API that fuses them and binds
# layer engines lives in ``repro_torch.compiler``.
from repro_torch.core.schedule import (HBM, PINNED,  # noqa: F401
                                       LayerSchedule, PipelinePlan,
                                       build_pipeline_plan)
