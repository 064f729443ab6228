"""The JAX package's fused path as a reference for the port's tests.

On jax releases that dropped ``jax.experimental.enable_x64``, the fused
modules (``core/micro_jax.py``, ``sim/engine_jax.py``) import only after
that name is aliased to ``jax.enable_x64``.  This script sets the alias
in its own interpreter, runs one case and writes the results to an
``.npz``; the test process never imports the fused modules.

    python tests/_jax_fused_ref.py greedy R SPR SEED OUT.npz
    python tests/_jax_fused_ref.py slice CASE OUT.npz
    python tests/_jax_fused_ref.py scan R SPR SEED FUSED OUT.npz
    python tests/_jax_fused_ref.py route CASE BACKEND FUSED SLOTS OUT.npz
    python tests/_jax_fused_ref.py spans OUT.npz

``scan`` runs the per-region micro route (``MicroAllocator(backend=
"jax", fused=FUSED)``) region by region over the randomized sweep and also
saves each ``fused_score`` matrix it used; ``route`` runs
``TortaScheduler(micro_backend=BACKEND, micro_fused_kernel=FUSED)`` on
``Engine(step_backend="numpy")``; ``spans`` runs the fused route on the
jitted engine step with ``obs="trace"`` on ``obs_world`` and saves each
span name's count.
"""
from __future__ import annotations

import sys

import jax
import jax.experimental
import numpy as np

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

from _torch_port import (OBS_SLOTS, SLICE_SLOTS, Recorder,  # noqa: E402
                         obs_world, ref_failures, ref_obs, slice_case,
                         sweep_slots)

import repro.kernels.compat_score as compat_score  # noqa: E402
from repro.core.micro import MicroAllocator  # noqa: E402
from repro.core.torta import TortaScheduler  # noqa: E402
from repro.sim import Engine  # noqa: E402


def greedy(r: int, spr: int, seed: int) -> dict:
    alloc = MicroAllocator(backend="fused")
    out = {}
    for t, cs, batch, region_of in sweep_slots(r, spr, seed):
        out[f"out_{t}"] = alloc.assign_batch_all(ref_obs(cs, t), batch,
                                                 region_of)
    for j in range(r):
        st = alloc.locality_state(j)
        if st is not None:
            for name in ("mids", "slots", "embeds", "norms", "count"):
                out[f"{name}_{j}"] = getattr(st, name)
    return out


def scan(r: int, spr: int, seed: int, fused: int) -> dict:
    alloc = MicroAllocator(backend="jax", fused=bool(fused))
    statics = []
    kernel = compat_score.fused_score

    def record(*args, **kw):
        out = kernel(*args, **kw)
        statics.append(np.asarray(out))
        return out
    compat_score.fused_score = record
    out = {}
    for t, cs, batch, region_of in sweep_slots(r, spr, seed):
        obs = ref_obs(cs, t)
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                out[f"out_{t}_{j}"] = alloc.assign_batch(obs, j, batch, idx)
    for j in range(r):
        st = alloc.locality_state(j)
        if st is not None:
            for name in ("mids", "slots", "embeds", "norms", "uid", "count"):
                out[f"{name}_{j}"] = getattr(st, name)
    for k, a in enumerate(statics):
        out[f"static_{k}"] = a
    return out


def slice_run(case: str, backend: str = "fused", fused: str = "0",
              slots: str = str(SLICE_SLOTS)) -> dict:
    """The fused slot on the jitted engine step, or another micro route on
    the numpy engine step."""
    c = slice_case(case)
    rec = Recorder(TortaScheduler(c.topo.n_regions, seed=0,
                                  micro_backend=backend,
                                  micro_fused_kernel=bool(int(fused)),
                                  use_sinkhorn_kernel=True))
    summary = Engine(c.topo, c.cs.copy(), c.workload, rec, seed=0,
                     failures=ref_failures(c.failures),
                     step_backend="jax" if backend == "fused" else "numpy"
                     ).run(int(slots)).summary()
    out = {"summary_keys": np.array(sorted(summary)),
           "summary_vals": np.array([summary[k] for k in sorted(summary)],
                                    np.float64)}
    for t, (region, server, _, _) in enumerate(rec.decisions):
        out[f"region_{t}"] = region
        out[f"server_{t}"] = server
    return out


def spans() -> dict:
    """Span names and counts of a traced fused run on ``obs_world``."""
    topo, cs, src, _ = obs_world()
    eng = Engine(topo, cs.copy(), src,
                 TortaScheduler(topo.n_regions, seed=0,
                                micro_backend="fused",
                                use_sinkhorn_kernel=True),
                 seed=4, step_backend="jax", obs="trace")
    eng.run(OBS_SLOTS)
    rows = eng.run_report.spans
    return {"names": np.array([row["name"] for row in rows]),
            "counts": np.array([row["count"] for row in rows], np.int64)}


def main(argv) -> None:
    mode, *args, path = argv
    if mode == "greedy":
        result = greedy(*(int(a) for a in args))
    elif mode == "scan":
        result = scan(*(int(a) for a in args))
    elif mode in ("slice", "route"):
        result = slice_run(*args)
    elif mode == "spans":
        result = spans()
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    np.savez(path, **result)


if __name__ == "__main__":
    main(sys.argv[1:])
