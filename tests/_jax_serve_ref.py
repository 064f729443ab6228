"""The JAX package's ``ServingCluster`` on ``examples/serve_e2e.py``'s
scenario, as a reference for the port's serving tests, in its own
interpreter: each model's ``forward`` and ``decode_step`` are wrapped in
``jax.jit`` here (un-jitted, the mixture-of-experts configs take minutes
on the CPU), and a compiler fault ends this process, not the test's.

    python tests/_jax_serve_ref.py MODEL[,MODEL...] OUT.npz

Runs the scenario (3 regions x 2 replicas, ``serve_e2e.torta_router``,
seeded arrivals of the given models with ``serve_e2e``'s shares) and
writes the cluster's stats, every finished request's ticks and output
tokens, and every model's weights (``w/<model>/<path>``) to ``OUT.npz``.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys
import time

import jax
import numpy as np

from repro.serving.serve_loop import Request, ServingCluster

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLUSTER = dict(seed=0, cache_len=64, max_batch=4)   # serve_e2e.run's
SHARES = [0.5, 0.3, 0.2]


def _serve_e2e():
    spec = importlib.util.spec_from_file_location(
        "serve_e2e", ROOT / "examples" / "serve_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Jitted:
    """A model whose ``forward`` and ``decode_step`` are jitted (the
    cache length a static argument); everything else is the model's."""

    def __init__(self, model):
        self.model = model
        self.forward = jax.jit(model.forward, static_argnames=(
            "return_cache", "cache_len", "last_logit_only"))
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self.model, name)


def drive(cluster, models, router, seed=0, ticks=70, arrive_until=32):
    """``serve_e2e.run``'s arrivals and ticks."""
    rng = np.random.default_rng(seed)
    rid = 0
    for t in range(ticks):
        if t < arrive_until and t % 2 == 0:
            for _ in range(2):
                m = models[int(rng.choice(len(models), p=SHARES))]
                cluster.submit(Request(id=rid, model=m,
                                       prompt=rng.integers(0, 255, 16),
                                       max_new=8))
                rid += 1
        cluster.run_tick(router)


def main(argv) -> None:
    names, path = argv[0].split(","), argv[1]
    t0 = time.perf_counter()
    cluster = ServingCluster(3, 2, names, **CLUSTER)
    for name, (model, params) in list(cluster.models.items()):
        cluster.models[name] = (Jitted(model), params)   # the replicas' dict
    drive(cluster, names, _serve_e2e().torta_router)
    stats = cluster.stats()
    done = sorted(cluster.done, key=lambda r: r.id)
    out = {"stats_keys": np.array(sorted(stats)),
           "stats_vals": np.array([stats[k] for k in sorted(stats)],
                                  np.float64),
           "ids": np.array([r.id for r in done], np.int64),
           "models": np.array([r.model for r in done]),
           "ticks": np.array([(r.submit_tick, r.first_token_tick,
                               r.done_tick) for r in done], np.int64),
           "outputs": np.array([r.output for r in done], np.int64)}
    for name, (_, params) in cluster.models.items():
        for keys, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out["w/" + name + "/" + "/".join(k.key for k in keys)] = \
                np.asarray(leaf)
    out["seconds"] = np.array(time.perf_counter() - t0)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
