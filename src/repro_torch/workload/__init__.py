"""Array-native workload (port of ``repro/workload``): ``TaskBatch``
streaming and the legacy object workload.  Scenarios and trace replay
are not ported yet."""
from repro_torch.workload.batch import EMBED_DIM, TaskBatch, zipf_model_mix
from repro_torch.workload.legacy import (Task, Workload, generate_traffic,
                                         make_workload)
from repro_torch.workload.stream import (LegacySource, StreamingWorkload,
                                         as_source)
