"""The port's serving path on the mixture-of-experts configs against the
JAX package's: ``examples/serve_e2e.py``'s scenario (3 regions x 2
replicas, 70 ticks of seeded arrivals, its ``torta_router``) over the
three reduced MoE configs (mixtral-8x7b, qwen3-moe-235b-a22b,
jamba-v0.1-52b), the JAX ``ServingCluster`` in a subprocess
(``_jax_serve_ref.py``, its models' ``forward`` and ``decode_step``
jitted there, with a timeout of its own) and the port's on the JAX
cluster's weights through ``interop.model_params_from_arrays``.  Stats,
every request's ticks and every output token must be equal."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_params_from_arrays
from repro_torch.models import Model
from repro_torch.serving.serve_loop import Request, ServingCluster
from test_torch_serving import CLUSTER, ROOT, _drive, _margin, _tap, serve_e2e

MOE = ["mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
REF_TIMEOUT_S = 300        # the jitted reference takes ~25 s on the CPU


def _reference(tmp_path) -> dict:
    out = tmp_path / "serve_ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    try:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "_jax_serve_ref.py"),
             ",".join(MOE), str(out)], env=env, capture_output=True,
            text=True, timeout=REF_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX ServingCluster took over {REF_TIMEOUT_S} s")
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-4000:],
                                  proc.stderr[-4000:])
    with np.load(out) as data:
        return dict(data)


def _weights(ref: dict, name: str) -> dict:
    """Model ``name``'s nested weight tree from the reference's flat
    ``w/<model>/<path>`` arrays."""
    tree: dict = {}
    prefix = f"w/{name}/"
    for key, arr in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return tree


def test_moe_scenario_matches_reference(tmp_path):
    ref = _reference(tmp_path)
    port = ServingCluster(3, 2, MOE, device="cpu", **CLUSTER)
    for name in MOE:
        cfg = reduced(get_config(name), layers=2, d_model=128, vocab=256)
        port.models[name] = Model(cfg, device="cpu", params=(
            model_params_from_arrays(cfg, _weights(ref, name), device="cpu")))
    log = []
    _tap(port, log, ref=False)
    stats, done = _drive(port, Request, serve_e2e.torta_router, models=MOE)
    want = dict(zip(ref["stats_keys"].tolist(), ref["stats_vals"].tolist()))
    assert {k: float(v) for k, v in stats.items()} == want
    assert stats["completed"] == 32
    assert sorted(done) == ref["ids"].tolist()
    for i, rid in enumerate(ref["ids"].tolist()):
        got = done[rid]
        assert got.model == ref["models"][i], rid
        assert (got.submit_tick, got.first_token_tick, got.done_tick) == \
            tuple(ref["ticks"][i].tolist()), rid
        want_out = ref["outputs"][i].tolist()
        if got.output != want_out:
            j = next(j for j, (a, b) in enumerate(zip(got.output, want_out))
                     if a != b)
            tick = got.first_token_tick + j
            pytest.fail(
                f"request {rid} ({got.model}): token {j} at tick {tick} is "
                f"{got.output[j]} in the port, {want_out[j]} in the "
                f"reference; the port's top-2 logit margin there: "
                f"{_margin(log, tick, rid)}")
