# The paper's planning passes (placement, FIFO sizing, fifo_sim), the
# schedule data model, and the §V-A credit-admission law live here; the
# staged compile() API that fuses them and binds layer engines lives in
# ``repro_torch.compiler``.
from repro_torch.core.admission import (AdmissionController,  # noqa: F401
                                        AdmissionError, AdmissionTrace,
                                        HeadOfQueue, WeightedFairScheduler,
                                        jain_fairness, replay_schedule)
from repro_torch.core.schedule import (HBM, PINNED,  # noqa: F401
                                       LayerSchedule, PipelinePlan,
                                       build_pipeline_plan)
