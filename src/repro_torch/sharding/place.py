"""Where each rank's shard of a tensor lies.

A dim whose spec entry names axes is cut into contiguous blocks, one per
index along those axes (the first axis major), in the order the
reference's ``NamedSharding`` gives devices their blocks; a dim whose
entry is ``None`` is whole on every rank.  So a rank's Q heads are a
contiguous run, and local Q head ``i`` still reads KV head ``i // G``
where the KV heads are sharded the same way.

A parameter declared with ``parts > 1`` (``models.params.ParamDesc``) is
a fused product of ``parts`` equal column blocks, each sharded on its
own: Mamba's ``in_proj`` is ``[x | z]``, and a rank holds its channels
of both halves, so its product needs no collective.  Its local shape is
the same as without parts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.specs import (AxisRules, P, batch_axes,
                                        spec_axes)

Tree = Any


def _entry(spec: Sequence, i: int):
    return spec[i] if i < len(spec) else None


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one rank; raises where a sharded dim does not
    divide (the reference's ``NamedSharding.shard_shape`` does too)."""
    out = []
    for i, n in enumerate(shape):
        k = math.prod(mesh.shape.get(a, 1)
                      for a in spec_axes(_entry(spec, i)))
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} ({n}) does not "
                             f"divide over {_entry(spec, i)!r} ({k})")
        out.append(n // k)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Named:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)


def axes_index(mesh, coord: Sequence[int], axes: Sequence[str]) -> int:
    """The index along ``axes`` taken together (the first major) of the
    rank at ``coord``: a tuple spec entry's block index."""
    i = 0
    for name in axes:
        k = mesh.axis_names.index(name)
        i = i * mesh.axis_sizes[k] + coord[k]
    return i


def _blocks(shape, spec, mesh, coord, parts: int = 1):
    """Per dim, the list of (start, length) ranges this rank holds."""
    out = []
    for i, n in enumerate(shape):
        axes = spec_axes(_entry(spec, i))
        k = math.prod(mesh.shape.get(a, 1) for a in axes)
        if k == 1:
            out.append([(0, n)])
            continue
        j = axes_index(mesh, coord, axes)
        part = n // parts
        out.append([(p * part + j * (part // k), part // k)
                    for p in range(parts)])
    return out


def _leaf_spec(desc) -> Tuple[Sequence, int]:
    if isinstance(desc, tuple):
        return desc, 1
    return desc.pspec, desc.parts


def shard_leaf(x, spec: Sequence, mesh, coord: Sequence[int],
               parts: int = 1):
    """This rank's shard of ``x`` (a numpy array or a tensor), copied."""
    local_shape(x.shape, spec, mesh)
    y = x
    for dim, ranges in enumerate(_blocks(x.shape, spec, mesh, coord,
                                         parts)):
        if ranges == [(0, x.shape[dim])]:
            continue
        pieces = [y[(slice(None),) * dim + (slice(a, a + n),)]
                  for a, n in ranges]
        if isinstance(y, torch.Tensor):
            y = torch.cat(pieces, dim) if len(pieces) > 1 else pieces[0]
        else:
            y = np.concatenate(pieces, dim) if len(pieces) > 1 else pieces[0]
    if isinstance(y, torch.Tensor):
        return y.clone(memory_format=torch.contiguous_format)
    return np.array(y)


def shard_tree(tree: Tree, specs: Tree, mesh, coord: Sequence[int]) -> Tree:
    """``tree`` sliced to the shards of the rank at ``coord``; ``specs``
    has its keys, each leaf a spec or a ``ParamDesc`` (whose ``pspec``
    and ``parts`` are used)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, coord)
                for k, v in tree.items()}
    spec, parts = _leaf_spec(specs)
    return shard_leaf(tree, spec, mesh, coord, parts)


def rank_coords(mesh) -> List[Tuple[int, ...]]:
    """The coordinate of every rank, in rank order (row-major)."""
    return [tuple(int(c) for c in np.unravel_index(r, mesh.axis_sizes))
            for r in range(math.prod(mesh.axis_sizes))]


def gather_tree(shards: Sequence[Tree], specs: Tree, mesh) -> Tree:
    """The inverse of :func:`shard_tree`: the whole tree from every
    rank's shards (``shards[r]`` of rank ``r``); a replicated block is
    taken from the first rank that holds it."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: gather_tree([s[k] for s in shards], specs[k], mesh)
                for k in first}
    spec, parts = _leaf_spec(specs)
    local = tuple(first.shape)
    full = tuple(n * math.prod(mesh.shape.get(a, 1)
                               for a in spec_axes(_entry(spec, i)))
                 for i, n in enumerate(local))
    out = torch.empty(full, dtype=first.dtype) if isinstance(
        first, torch.Tensor) else np.empty(full, dtype=first.dtype)
    for shard, coord in zip(shards, rank_coords(mesh)):
        ranges = _blocks(full, spec, mesh, coord, parts)
        # place each combination of the per-dim ranges
        offsets = [np.cumsum([0] + [n for _, n in r])[:-1] for r in ranges]
        for combo in np.ndindex(*[len(r) for r in ranges]):
            dst = tuple(slice(ranges[d][c][0], ranges[d][c][0] + ranges[d][c][1])
                        for d, c in enumerate(combo))
            src = tuple(slice(offsets[d][c], offsets[d][c] + ranges[d][c][1])
                        for d, c in enumerate(combo))
            out[dst] = shard[src]
    return out


def batch_sharded(rules: AxisRules, batch: int) -> bool:
    """Whether a batch of ``batch`` splits over the data axes (the
    reference's ``_batch_spec`` names them), rather than being whole on
    every rank."""
    return rules.mesh is None or batch % max(
        rules.axis_size(batch_axes(rules)), 1) == 0


def batch_block(rules: AxisRules, batch: int) -> slice:
    """The rows of a batch of ``batch`` this rank computes."""
    n = batch_block_size(rules, batch)
    if n == batch or rules.mesh is None or not rules.mesh.bound:
        return slice(0, batch)
    i = rules.mesh.index(spec_axes(batch_axes(rules)))
    return slice(i * n, (i + 1) * n)


def batch_block_size(rules: AxisRules, batch: int) -> int:
    if rules.mesh is None or not batch_sharded(rules, batch):
        return batch
    return batch // rules.axis_size(batch_axes(rules))
