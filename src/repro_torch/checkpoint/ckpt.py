"""Msgpack checkpoints of parameter trees (port of
``repro/checkpoint/ckpt.py``, same file format; a file written by either
package loads in the other).

A checkpoint is ``<path>/ckpt_<step:08d>.msgpack``, written atomically
through a ``.tmp`` rename.  Its payload is ``{b"step", b"treedef",
b"leaves"}``; each array leaf is ``{b"__arr__": True, b"dtype", b"shape",
b"data"}`` (numpy dtype name, shape list, raw C-order bytes), any other
leaf is stored as itself.  Leaves go in jax's flatten order, computed
here without jax: dict keys sorted, lists and tuples in order,
namedtuples by field, ``None`` an empty subtree; any other container
raises ``TypeError``.  ``treedef`` is the text ``str(jax.tree.flatten(
tree)[1])`` gives, so a port file and a reference file of the same tree
are byte-equal; the loader ignores it, as the reference's does.

Leaves may be torch tensors on any device, or numpy arrays.  bfloat16
is written as dtype ``"bfloat16"`` with its raw bytes and read back into
a ``torch.bfloat16`` tensor (no ``ml_dtypes``).
"""
from __future__ import annotations

import os
import pathlib
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.msgpack import packb, unpackb

Tree = Any
_SCALARS = (bool, int, float, str)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, np.generic)
                      + _SCALARS)


def flatten(tree: Tree) -> Tuple[List[Any], str]:
    """(leaves in jax's order, the ``PyTreeDef(...)`` text of the
    structure)."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if type(node) is dict:
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(v) for v in node) + "])")
        if type(node) is tuple:
            inner = ", ".join(walk(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if type(node) is list:
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if _is_leaf(node):
            leaves.append(node)
            return "*"
        raise TypeError(f"checkpoint tree: cannot flatten a "
                        f"{type(node).__name__}")
    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(template: Tree, leaves) -> Tree:
    """``template``'s structure with its leaves taken from the iterator
    ``leaves``, each cast to the template leaf's dtype."""
    if template is None:
        return None
    if type(template) is dict:
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if type(template) in (tuple, list):
        return type(template)(_unflatten(v, leaves) for v in template)
    if not _is_leaf(template):
        raise TypeError(f"checkpoint template: cannot flatten a "
                        f"{type(template).__name__}")
    try:
        return _cast(template, next(leaves))
    except StopIteration:
        raise ValueError("checkpoint holds fewer leaves than the "
                         "template") from None


def _array_leaf(dtype: str, shape, data: bytes) -> dict:
    return {b"__arr__": True, b"dtype": dtype, b"shape": list(shape),
            b"data": data}


def _encode_leaf(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return _array_leaf("bfloat16", t.shape,
                               t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        return _array_leaf(arr.dtype.name, arr.shape, arr.tobytes())
    return x


def _decode_leaf(x):
    """An array leaf of a payload unpacked with ``raw=True`` (bytes keys
    and strings); any other value as it is."""
    if isinstance(x, dict) and b"__arr__" in x:
        dt, shape, data = x[b"dtype"].decode(), x[b"shape"], x[b"data"]
        if dt == "bfloat16":
            flat = (torch.frombuffer(bytearray(data), dtype=torch.bfloat16)
                    if data else torch.empty(0, dtype=torch.bfloat16))
            return flat.reshape(shape)
        return np.frombuffer(data, dtype=np.dtype(dt)).reshape(shape).copy()
    return x


def _cast(template, x):
    """``x`` in the template leaf's dtype (and, for a tensor template, on
    its device); a template leaf with no dtype takes ``x`` as stored."""
    if isinstance(template, torch.Tensor):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=template.device, dtype=template.dtype)
    if isinstance(template, (np.ndarray, np.generic)):
        if isinstance(x, torch.Tensor):
            x = x.float().numpy() if x.dtype == torch.bfloat16 \
                else x.numpy()
        return np.asarray(x, template.dtype)
    return x


def save_checkpoint(path, step: int, tree: Tree) -> str:
    """Write ``<path>/ckpt_<step:08d>.msgpack`` atomically; returns the
    filename."""
    d = pathlib.Path(path)
    d.mkdir(parents=True, exist_ok=True)
    leaves, treedef = flatten(tree)
    payload = {
        b"step": step,
        b"treedef": treedef,
        b"leaves": [_encode_leaf(leaf) for leaf in leaves],
    }
    fn = d / f"ckpt_{step:08d}.msgpack"
    tmp = fn.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(packb(payload))
    os.replace(tmp, fn)
    return str(fn)


def latest_step(path) -> Optional[int]:
    d = pathlib.Path(path)
    if not d.exists():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := re.match(r"ckpt_(\d+)\.msgpack$", p.name))]
    return max(steps) if steps else None


def load_checkpoint(path, template: Tree, step: Optional[int] = None
                    ) -> Tuple[int, Tree]:
    """Restore into the structure of ``template``: each leaf cast to the
    template leaf's dtype, a tensor leaf onto the template leaf's device.
    Raises ``FileNotFoundError`` when no checkpoint exists."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    fn = pathlib.Path(path) / f"ckpt_{step:08d}.msgpack"
    with open(fn, "rb") as f:
        payload = unpackb(f.read(), raw=True)
    leaves = [_decode_leaf(leaf) for leaf in payload[b"leaves"]]
    it = iter(leaves)
    tree = _unflatten(template, it)
    if next(it, it) is not it:
        raise ValueError("checkpoint holds more leaves than the template")
    return int(payload[b"step"]), tree
