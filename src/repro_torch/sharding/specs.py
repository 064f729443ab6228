"""Mesh-axis rules and divisibility-aware sharding helpers, the port's
counterpart of ``repro/sharding/specs.py``.

The production mesh is ``("data", "model")``, with an optional leading
``"pod"`` axis for the multi-pod run.  Batch dims shard over ``("pod",
"data")``; weight column/row dims over ``"model"``; large weights may
additionally be FSDP-sharded over ``"data"`` (storage sharding: the
weight is all-gathered over ``data`` just before its use).

A dim is only sharded when divisible by the product of the requested
axis sizes.  The port has no compiler that places data: each rank holds
only its shards, named by these specs (``sharding/place.py``), and the
model calls every collective itself (``sharding/collectives.py``).  So
:func:`constrain` moves nothing: it checks that a tensor's local shape is
the one the spec gives it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

AxisName = Union[str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry a dim, each ``None`` (replicated), an
    axis name, or a tuple of names (sharded over their product, the first
    name major).  Dims past its length are replicated.  Prints as
    ``PartitionSpec(...)`` and compares equal to a tuple of the same
    entries, as the reference's ``PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec({tuple.__repr__(self)[1:-1]})"

    __str__ = __repr__


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Policy knobs for how the model maps onto the mesh
    (``launch.mesh.Mesh``, abstract or bound to ranks)."""
    mesh: Optional[Any] = None
    # FSDP: additionally shard large weight tensors' non-model dim over data.
    fsdp: bool = False
    # sequence-parallel activations: residual stream sharded over this axis
    # between blocks (set by the launcher for long-sequence shapes); the
    # port's model raises on it (a later slice)
    seq_axis: Optional[str] = None
    tensor_axis: str = "model"
    expert_axis: str = "model"

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if self.mesh is None:
            return ("data",)
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    def axis_size(self, name: AxisName) -> int:
        if self.mesh is None:
            return 1
        if isinstance(name, tuple):
            return math.prod(self.axis_size(n) for n in name)
        return self.mesh.shape.get(name, 1)

    def divisible(self, dim: int, name: AxisName) -> bool:
        sz = self.axis_size(name)
        return sz > 1 and dim % sz == 0


DEFAULT_RULES = AxisRules()


def shard_axis(rules: AxisRules, dim: int, name: AxisName
               ) -> Optional[AxisName]:
    """The axis name if ``dim`` is divisible by its mesh size, else None
    (without a mesh the name, as the reference gives it)."""
    if rules.mesh is None:
        return name
    return name if rules.divisible(dim, name) else None


def batch_axes(rules: AxisRules) -> AxisName:
    axes = rules.data_axes
    return axes if len(axes) > 1 else axes[0]


def constrain(x, rules: AxisRules, spec: Sequence,
              shape: Optional[Sequence[int]] = None):
    """Return ``x``, after checking it against ``spec``: no more spec
    entries than dims and, given the global ``shape``, ``x``'s shape is
    this rank's shard of it.  Moves no data (the reference's
    ``with_sharding_constraint`` asks XLA to place it)."""
    if len(spec) > x.ndim:
        raise ValueError(f"constrain: spec {spec} has more entries than "
                         f"the tensor's {x.ndim} dims")
    if shape is not None and rules.mesh is not None:
        from repro_torch.sharding.place import local_shape
        want = local_shape(shape, spec, rules.mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"constrain: local shape {tuple(x.shape)}, "
                             f"spec {spec} of {tuple(shape)} gives {want}")
    return x


def named(rules: AxisRules, spec: Sequence):
    """The spec on the rules' mesh (``place.Named``, whose
    ``shard_shape`` is the reference's ``NamedSharding.shard_shape``), or
    None without a mesh."""
    if rules.mesh is None:
        return None
    from repro_torch.sharding.place import Named
    return Named(rules.mesh, P(*spec))
