"""Optimizers and learning-rate schedules (port of ``repro/optim``)."""
from repro_torch.optim.adam import (Adam, AdamState, Sgd, apply_updates,
                                    clip_by_global_norm)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         exponential_decay, warmup_cosine)
