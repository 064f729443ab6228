"""Array-native workload (port of ``repro/workload``): ``TaskBatch``
streaming, the scenario registry (diurnal / multi-day / flash-crowd /
outage / trace-replay regimes), trace loading, and the legacy object
workload."""
from repro_torch.workload.batch import (EMBED_DIM, MODEL_KIND_ID,
                                        MODEL_MEM_GB, MODEL_WORK_S,
                                        TaskBatch, group_rows,
                                        zipf_model_mix)
from repro_torch.workload.legacy import (Task, Workload, generate_traffic,
                                         make_workload)
from repro_torch.workload.scenarios import (get_scenario, list_scenarios,
                                            make_source, register_scenario)
from repro_torch.workload.stream import (LegacySource, StreamingWorkload,
                                         as_source, to_legacy_workload)
from repro_torch.workload.trace import (DEFAULT_TRACE, load_trace,
                                        resample_trace)

__all__ = [
    "EMBED_DIM", "MODEL_KIND_ID", "MODEL_MEM_GB", "MODEL_WORK_S",
    "TaskBatch", "group_rows", "zipf_model_mix",
    "Task", "Workload", "generate_traffic", "make_workload",
    "LegacySource", "StreamingWorkload", "as_source", "to_legacy_workload",
    "DEFAULT_TRACE", "load_trace", "resample_trace",
    "get_scenario", "list_scenarios", "make_source", "register_scenario",
]
