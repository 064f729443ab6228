"""Meshes of ranks, the port's counterpart of ``repro/launch/mesh.py``.

A :class:`Mesh` names its axes and their sizes.  Abstract, it is what the
partition specs and the dry run read (``make_production_mesh``: 16 x 16
``(data, model)``, and 2 x 16 x 16 with a leading ``pod`` axis).  Bound
to an initialised ``torch.distributed`` process group by
:func:`init_mesh`, it also holds this rank's coordinate, the
``DeviceMesh`` over the ranks (rank ``r`` at ``unravel(r, sizes)``) and
the process group of every axis and every tuple of axes, which the
collectives of ``sharding/collectives.py`` run over.

:func:`spawn` runs a function on every rank of a mesh in processes of
its own, for the tests and ``chip_smoke.py``: a ``FileStore`` in a
temporary directory is the rendezvous (no port to collide with another
run), the caller names the backend and the device, and a rank that
raises fails the call.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sharding.place import axes_index, rank_coords


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; bound (``init_mesh``) also this rank's
    coordinate, its ``DeviceMesh`` and its process groups."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coord: Optional[Tuple[int, ...]] = None
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)
    groups: Optional[Dict[Tuple[str, ...], Any]] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def bound(self) -> bool:
        return self.coord is not None

    def index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` taken together, the first
        major (a tuple spec entry's block index)."""
        return axes_index(self, self.coord, axes)

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes``."""
        return self.groups[tuple(a for a in self.axis_names if a in axes)]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16 x 16 ``(data, model)``, or
    2 x 16 x 16 ``(pod, data, model)`` (256 and 512 chips), abstract."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(data: int = 2, model: int = 2) -> Mesh:
    """Small abstract ``(data, model)`` mesh for multi-rank tests."""
    return Mesh(("data", "model"), (data, model))


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size


def init_mesh(mesh: Mesh, *, backend: str, device) -> Mesh:
    """``mesh`` bound to the initialised default process group, whose
    backend must be ``backend`` and whose size must be the mesh's: its
    ``DeviceMesh`` on ``device``'s type (the groups of single axes), the
    groups of every tuple of axes, and this rank's coordinate.  Every
    rank calls it, in the same order as any other group creation."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("init_mesh: initialise the process group first")
    if dist.get_backend() != backend:
        raise ValueError(f"init_mesh: the process group's backend is "
                         f"{dist.get_backend()!r}, not {backend!r}")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"init_mesh: {dist.get_world_size()} ranks for a "
                         f"mesh of {mesh.size}")
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    dm = DeviceMesh(device.type, ranks, mesh_dim_names=mesh.axis_names)
    coord = rank_coords(mesh)[dist.get_rank()]
    groups: Dict[Tuple[str, ...], Any] = {
        (name,): dm.get_group(name) for name in mesh.axis_names}
    n = len(mesh.axis_names)
    for k in range(2, n + 1):
        for dims in itertools.combinations(range(n), k):
            key = tuple(mesh.axis_names[d] for d in dims)
            if k == n:
                groups[key] = dist.group.WORLD
                continue
            rest = [d for d in range(n) if d not in dims]
            # one group per coordinate of the other axes, created by
            # every rank in the same order; this rank keeps its own
            moved = ranks.permute(*rest, *dims).reshape(
                -1, math.prod(mesh.axis_sizes[d] for d in dims))
            for row in moved.tolist():
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    groups[key] = g
    return dataclasses.replace(mesh, coord=coord, device_mesh=dm,
                               groups=groups)


def _rank_main(rank: int, fn, mesh: Mesh, backend: str, device: str,
               args: tuple, store: str, out: str, timeout_s: float) -> None:
    """One rank: join the group through the file store, bind the mesh,
    run ``fn(mesh, *args)`` and save ("ok", result) or ("error",
    traceback) to ``out``."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store, mesh.size), rank=rank,
            world_size=mesh.size,
            timeout=datetime.timedelta(seconds=timeout_s))
        bound = init_mesh(mesh, backend=backend, device=dev)
        result = fn(bound, *args)
    except BaseException:
        _save(("error", traceback.format_exc()), out)
        raise
    _save(("ok", result), out)
    dist.destroy_process_group()


def _save(result: tuple, out: str) -> None:
    """Write a rank's result whole or not at all."""
    torch.save(result, out + ".tmp")
    os.replace(out + ".tmp", out)


def spawn(fn, mesh: Mesh, *, backend: str, device, args: tuple = (),
          timeout_s: float = 600.0) -> list:
    """Run ``fn(bound_mesh, *args)`` on every rank of ``mesh``, one
    process a rank (``torch.multiprocessing``'s spawn start; ``fn`` and
    ``args`` are pickled to each, CUDA tensors shared through
    ``torch.multiprocessing``).  Returns the ranks' results in rank
    order, loaded onto the host.  A rank that raises fails the call with
    its traceback, at once: the other ranks are terminated.  Every
    process is stopped before the call returns."""
    device = resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh-")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(mesh.size)]
    procs = [ctx.Process(target=_rank_main, args=(
        r, fn, mesh, backend, str(device), args, os.path.join(tmp, "store"),
        outs[r], timeout_s), daemon=True) for r in range(mesh.size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 60.0
        results: Dict[int, Any] = {}
        while len(results) < mesh.size:
            for r, p in enumerate(procs):
                if r in results:
                    continue
                if os.path.exists(outs[r]):
                    status, value = torch.load(outs[r], map_location="cpu",
                                               weights_only=False)
                    if status == "error":
                        raise RuntimeError(f"rank {r} failed:\n{value}")
                    results[r] = value
                elif not p.is_alive():
                    raise RuntimeError(f"rank {r} exited with code "
                                       f"{p.exitcode} and no result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: ranks {sorted(set(range(mesh.size)) - set(results))} "
                                   f"gave no result in {timeout_s:.0f} s")
            time.sleep(0.01)
        for p in procs:
            p.join(30.0)
        return [results[r] for r in range(mesh.size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(tmp, ignore_errors=True)
