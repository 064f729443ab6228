"""The port's serving path against the JAX package's: the
``examples/serve_e2e.py`` scenario (3 regions x 2 replicas, the three
reduced models, 70 ticks of seeded arrivals, its ``torta_router``) on the
JAX ``ServingCluster`` and on the port's, the port's weights replaced by
the JAX cluster's through ``interop.model_params_from_arrays``.  Stats and
every request's output tokens must be equal; a differing token is
reported with its decode step's top-2 logit margin on both sides."""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

from repro.serving.serve_loop import Request as RefRequest
from repro.serving.serve_loop import ServingCluster as RefServingCluster
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_params_from_arrays
from repro_torch.models import Model
from repro_torch.serving.serve_loop import Request, ServingCluster

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "serve_e2e", ROOT / "examples" / "serve_e2e.py")
serve_e2e = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve_e2e)
MODELS = serve_e2e.MODELS
CLUSTER = dict(seed=0, cache_len=64, max_batch=4)   # serve_e2e.run's


class Tap:
    """Stands in for a model and records each decode step's logits with
    the replica's tick and the request ids in its slots."""

    def __init__(self, inner, now, log):
        self.inner, self.now, self.log = inner, now, log

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decode_step(self, *args):
        logits, cache = self.inner.decode_step(*args)
        self.log.append((*self.now[0], np.array(logits, np.float32)))
        return logits, cache


def _tap(cluster, log, ref: bool):
    now = [None]
    for name, entry in list(cluster.models.items()):
        if ref:
            cluster.models[name] = (Tap(entry[0], now, log), entry[1])
        else:
            cluster.models[name] = Tap(entry, now, log)
    for region in cluster.regions:
        for rep in region:
            def step(tick, rep=rep, inner=rep.step):
                now[0] = (tick, [None if r is None else r.id
                                 for r in rep.slots])
                inner(tick)
            rep.step = step


def _bridge(ref_cluster, cluster):
    """The port cluster's models on the JAX cluster's weights."""
    for name, (_, params) in ref_cluster.models.items():
        cfg = reduced(get_config(name), layers=2, d_model=128, vocab=256)
        tree = jax.tree.map(np.asarray, params)
        cluster.models[name] = Model(
            cfg, device="cpu",
            params=model_params_from_arrays(cfg, tree, device="cpu"))


def _drive(cluster, request_cls, router, seed=0, ticks=70, arrive_until=32,
           models=MODELS):
    """``serve_e2e.run``'s arrivals (of ``models``, at its shares) and
    ticks on a given cluster."""
    rng = np.random.default_rng(seed)
    rid = 0
    for t in range(ticks):
        if t < arrive_until and t % 2 == 0:
            for _ in range(2):
                m = models[int(rng.choice(len(models), p=[0.5, 0.3, 0.2]))]
                cluster.submit(request_cls(id=rid, model=m,
                                           prompt=rng.integers(0, 255, 16),
                                           max_new=8))
                rid += 1
        cluster.run_tick(router)
    return cluster.stats(), {r.id: r for r in cluster.done}


@pytest.fixture(scope="module")
def runs():
    ref = RefServingCluster(3, 2, MODELS, **CLUSTER)
    port = ServingCluster(3, 2, MODELS, device="cpu", **CLUSTER)
    _bridge(ref, port)
    logs = {"ref": [], "port": []}
    _tap(ref, logs["ref"], ref=True)
    _tap(port, logs["port"], ref=False)
    out = {"ref": _drive(ref, RefRequest, serve_e2e.torta_router),
           "port": _drive(port, Request, serve_e2e.torta_router)}
    return out, logs


def _margin(log, tick, rid):
    """Top-2 logit margin of request ``rid``'s decode row at ``tick``."""
    for t, ids, logits in log:
        if t == tick and rid in ids:
            top = np.sort(logits[ids.index(rid)])[-2:]
            return float(top[1] - top[0])
    return None


def test_stats_equal(runs):
    out, _ = runs
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0]["completed"] == 32


def test_outputs_equal(runs):
    out, logs = runs
    ref_done, done = out["ref"][1], out["port"][1]
    assert sorted(done) == sorted(ref_done)
    for rid in sorted(ref_done):
        want, got = ref_done[rid], done[rid]
        assert (got.submit_tick, got.first_token_tick, got.done_tick) == (
            want.submit_tick, want.first_token_tick, want.done_tick), rid
        if got.output != want.output:
            i = next(j for j, (a, b) in enumerate(zip(got.output, want.output))
                     if a != b)
            tick = want.first_token_tick + i
            pytest.fail(
                f"request {rid} ({want.model}): token {i} at tick {tick} is "
                f"{got.output[i]} in the port, {want.output[i]} in the "
                f"reference; top-2 logit margin there: reference "
                f"{_margin(logs['ref'], tick, rid)}, port "
                f"{_margin(logs['port'], tick, rid)}")


def test_router_cuts_switches(runs):
    """``serve_e2e.py``'s assertion on the port: the TORTA router switches
    models no more often than round-robin."""
    out, _ = runs
    rr = ServingCluster(3, 2, MODELS, device="cpu", **CLUSTER)
    s_rr, _ = _drive(rr, Request, serve_e2e.rr_router_factory())
    assert s_rr["completed"] == 32
    assert out["port"][0]["model_switches"] <= s_rr["model_switches"]
