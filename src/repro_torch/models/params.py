"""Parameter declaration of the port's models: names, shapes and
initialisers.

Every parameter is declared once as a :class:`ParamDesc` with the name,
shape, partition spec and initialiser kind the reference gives it
(``repro/models/params.py``), so a weight tree of the reference maps leaf
to leaf (``interop.model_params_from_arrays``), ``param_shapes`` gives
the tree's shapes on the ``meta`` device without allocating it, and
``param_pspecs`` its partition specs (``sharding/place.py`` cuts a rank's
shards by them).
Initialisers draw from an
explicit ``torch.Generator``, on that generator's device; their bits
differ from ``jax.random``'s, their distributions do not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding.place import local_shape
from repro_torch.sharding.specs import P

Tree = Any


@dataclasses.dataclass
class ParamDesc:
    shape: Tuple[int, ...]
    init: str = "normal"     # normal | zeros | ones | scaled | conv | a_log | dt_bias
    scale: float = 1.0       # fan-in handled by "scaled"
    pspec: Optional[P] = None    # default: every dim replicated
    # a fused product of ``parts`` equal column blocks, each sharded on its
    # own (``sharding/place.py``)
    parts: int = 1

    def __post_init__(self):
        if self.pspec is None:
            self.pspec = P(*(None,) * len(self.shape))

    def stack(self, g: int) -> "ParamDesc":
        return ParamDesc((g,) + self.shape, self.init, self.scale,
                         P(None, *self.pspec), self.parts)


def _materialize(desc: ParamDesc, gen: torch.Generator) -> torch.Tensor:
    """One float32 parameter, drawn on ``gen``'s device (the reference's
    kinds and fan-in rule, applied to the stacked shape as the reference
    does)."""
    s, dev = desc.shape, gen.device
    if desc.init == "zeros":
        return torch.zeros(s, device=dev)
    if desc.init == "ones":
        return torch.ones(s, device=dev)
    if desc.init == "a_log":
        # mamba: A = -exp(A_log); init A_log = log(arange(1, N+1)) broadcast
        a = torch.log(torch.arange(1, s[-1] + 1, dtype=torch.float32,
                                   device=dev))
        return a.expand(s).clone()
    if desc.init == "dt_bias":
        # mamba dt bias: inverse-softplus of uniform in [1e-3, 1e-1]
        u = torch.rand(s, generator=gen, device=dev) * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u))
    if desc.init in ("normal", "scaled", "conv"):
        fan_in = s[-2] if len(s) >= 2 else s[-1]
        if desc.init == "conv":
            fan_in = s[0]
        std = desc.scale / math.sqrt(max(fan_in, 1))
        return torch.randn(s, generator=gen, device=dev).mul_(std)
    raise ValueError(desc.init)


def init_params(tree: Tree, gen: torch.Generator) -> Tree:
    """The descriptor tree's float32 parameters, drawn in sorted-key
    order."""
    if isinstance(tree, ParamDesc):
        return _materialize(tree, gen)
    return {k: init_params(tree[k], gen) for k in sorted(tree)}


def _leaves(tree: Tree):
    if isinstance(tree, ParamDesc):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def param_shapes(tree: Tree, dtype: torch.dtype = torch.bfloat16) -> Tree:
    """The descriptor tree as tensors on the ``meta`` device: each leaf has
    its descriptor's shape and ``dtype`` and no storage (the counterpart
    of the reference's ``jax.ShapeDtypeStruct`` tree)."""
    if isinstance(tree, ParamDesc):
        return torch.empty(tree.shape, dtype=dtype, device="meta")
    return {k: param_shapes(v, dtype) for k, v in tree.items()}


def param_pspecs(tree: Tree) -> Tree:
    """The descriptor tree's partition specs."""
    if isinstance(tree, ParamDesc):
        return tree.pspec
    return {k: param_pspecs(v) for k, v in tree.items()}


def local_descs(tree: Tree, mesh) -> Tree:
    """The descriptors of one rank's shards on ``mesh``: each shape cut
    by its spec (None: the tree as is)."""
    if mesh is None:
        return tree
    if isinstance(tree, ParamDesc):
        return dataclasses.replace(
            tree, shape=local_shape(tree.shape, tree.pspec, mesh))
    return {k: local_descs(v, mesh) for k, v in tree.items()}


def count_params(tree: Tree) -> int:
    return sum(math.prod(d.shape) for d in _leaves(tree))


def param_bytes(tree: Tree, bytes_per: int = 2) -> int:
    return count_params(tree) * bytes_per


def stack_tree(tree: Tree, g: int) -> Tree:
    """Add a leading group dimension of size g to every descriptor."""
    if isinstance(tree, ParamDesc):
        return tree.stack(g)
    return {k: stack_tree(v, g) for k, v in tree.items()}


def check_tree(descs: Tree, tree: Tree, path: str = "") -> None:
    """Raise unless ``tree`` has exactly the descriptors' keys, and each
    leaf their shape."""
    if isinstance(descs, ParamDesc):
        shape = tuple(getattr(tree, "shape", ()))
        if shape != tuple(descs.shape):
            raise ValueError(f"parameter {path or '/'}: shape {shape}, "
                             f"expected {descs.shape}")
        return
    if not isinstance(tree, dict) or set(tree) != set(descs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"parameter tree {path or '/'}: keys {got}, "
                         f"expected {sorted(descs)}")
    for k in descs:
        check_tree(descs[k], tree[k], f"{path}/{k}")


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``: dict nodes are
    child modules, leaves frozen parameters (the models only infer)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        """The parameters as the nested dict they were given as."""
        out: Dict[str, Any] = dict(self.named_parameters(recurse=False))
        out.update((k, m.tree()) for k, m in self.named_children())
        return out
