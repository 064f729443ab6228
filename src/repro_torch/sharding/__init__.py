"""The sharding tier: partition specs and axis rules equal to the
reference's (``specs``), where each rank's shard of a tensor lies
(``place``), and the collectives the sharded model calls in place of
those XLA inserts (``collectives``)."""
from repro_torch.sharding.specs import (DEFAULT_RULES, AxisRules, P,
                                        batch_axes, constrain, named,
                                        shard_axis)
