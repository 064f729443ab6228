"""The port's sharded serving path on the CPU: four ranks spawned with
``launch.mesh.spawn`` over ``gloo`` (a ``FileStore`` rendezvous), each
holding its shards of a reduced model, run the forward, whisper's
``encode``, the prefill step and 4 decode ticks on a (data 2, model 2)
mesh, or on another mesh the same ranks rebind to.  The weights are
float32 draws of the reference's initialisers (the port's
``init_params``), given to both packages as numpy arrays.  Held:

- to the port's unsharded ``Model`` on the same weights and inputs: the
  logits of every rank's batch block (identical across the ``model``
  ranks), the cache gathered from the ranks' shards, the encoder output,
  the balance loss, within 1e-4 relative to the value's size,
  |got - want| <= 1e-4 (1 + |want|): a row-parallel product's partial
  sums are the unsharded product's terms added in another order;
- to the reference's single-device ``Model.forward``, within
  ``test_torch_models.py``'s 5e-4 (whisper and paligemma in float64 on
  both sides, as ``test_torch_whisper.py`` runs whisper: in float32 the
  reference's own rounding at these widths reaches the tolerance);
- the MoE bodies the reference's ``moe_ffn`` picks (``moe.BODIES``):
  expert-parallel (mixtral, jamba), tensor-parallel experts (mixtral cut
  to 3 experts, which do not divide ``model``), the decode-scale 2-D
  body (FSDP), the whole batch's routing where ``model`` is 1 (a (4, 1)
  mesh); the balance loss is the mean of the data blocks' where dispatch
  stays within a block;
- the collectives each rank recorded (``collectives.tally``) equal to
  ``collectives.step_collectives`` for the prefill step and every tick;
- paligemma's cache (1 KV head) would be context-parallel on ``model``
  and is refused; granite's 1 KV head with an odd cache length, a 6-head
  / 3-KV-head config (one KV head per local Q head) and whisper cut to
  one head (the d-sharded layout) run.

All the models run in one spawn (the ranks' side is
``tests/_shard_ranks.py``, free of jax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import Model as RefModel
import repro_torch.configs as configs
from repro_torch.configs import RunShape
from repro_torch.interop import model_params_from_arrays
from repro_torch.launch.mesh import make_test_mesh, spawn
from repro_torch.models import Model
from repro_torch.models.model import cache_pspecs, param_descs
from repro_torch.models.params import init_params
from repro_torch.serving.steps import make_prefill_step
from repro_torch.sharding import collectives
from repro_torch.sharding.place import gather_tree
from repro_torch.sharding.specs import AxisRules
from _shard_ranks import config

TOL_PORT = 1e-4
TOL_REF = 5e-4
BATCH, PROMPT, TICKS = 4, 8, 4

# the models, all run in one spawn of 4 ranks on a (2, 2) mesh: (arch,
# config changes, dtype, cache_len, decode, FSDP, the (data, model) mesh
# its ranks rebind to or None, the MoE body it runs or None)
MODELS = [
    ("llama3-8b", {}, "float32", 16, True, False, None, None),
    ("mixtral-8x7b", {}, "float32", 16, True, False, None, "expert"),
    ("falcon-mamba-7b", {}, "float32", 16, True, False, None, None),
    ("jamba-v0.1-52b", {}, "float32", 16, True, False, None, "expert"),
    ("whisper-small", {}, "float64", 16, True, False, None, None),
    ("paligemma-3b", {}, "float64", 24, False, False, None, None),
    ("granite-20b", {}, "float32", 15, True, False, None, None),
    # 3 experts do not divide model = 2: an F-slice of every expert a rank
    ("mixtral-8x7b", {"moe": {"num_experts": 3}}, "float32", 16, True,
     False, None, "tensor"),
    # one head does not divide model = 2: the d-sharded layout
    ("whisper-small", {"num_heads": 1, "num_kv_heads": 1}, "float64", 15,
     True, False, None, None),
    # 3 local Q heads of groups of 2 over 3 whole KV heads
    ("tinyllama-1.1b", {"num_heads": 6, "num_kv_heads": 3, "head_dim": 32},
     "float32", 15, True, False, None, None),
    # model = 1: the whole batch's routing (tokens gathered over data)
    ("mixtral-8x7b", {}, "float32", 16, True, False, (4, 1), "gathered"),
    # FSDP at a decode-scale batch: the 2-D body; the dense FFN's gathers
    ("mixtral-8x7b", {}, "float32", 16, True, True, None, "2d"),
    ("llama3-8b", {}, "float32", 16, True, True, None, None),
]
IDS = [f"{i}-{m[0]}" + ("-fsdp" if m[5] else "") +
       (f"-{m[6][0]}x{m[6][1]}" if m[6] else "") +
       ("-" + "-".join(f"{k}{v}" for k, v in m[1].items()) if m[1] else "")
       for i, m in enumerate(MODELS)]
IDS = [i.replace("{", "").replace("}", "").replace("'", "").replace(
    ": ", "").replace(" ", "") for i in IDS]


def _inputs(cfg, batch):
    """Seeded numpy tokens and the vision / encoder inputs (x 0.02)."""
    rng = np.random.default_rng(11)
    out = {}
    if cfg.encoder is not None:
        out["frames"] = (rng.standard_normal(
            (batch, cfg.encoder.src_len, cfg.d_model)) * 0.02)
    if cfg.vision is not None:
        out["patches"] = (rng.standard_normal(
            (batch, cfg.vision.num_patches, cfg.vision.embed_dim)) * 0.02)
    toks = rng.integers(0, cfg.vocab, (batch, PROMPT + TICKS))
    return toks, {k: v.astype(np.float32) for k, v in out.items()}


def _spec(i):
    arch, changes, dtype, cache_len, decode, fsdp, rebound, _ = MODELS[i]
    cfg = config(configs, arch, changes)
    # float32 weights of the reference's initialisers, drawn by the port's
    tree = _numpy(init_params(param_descs(cfg),
                              torch.Generator().manual_seed(i)))
    toks, inputs = _inputs(cfg, BATCH)
    return dict(arch=arch, changes=changes, dtype=dtype, cache_len=cache_len,
                decode=decode, mesh=rebound, fsdp=fsdp, tree=tree,
                tokens=toks, inputs=inputs, prompt=PROMPT)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def runs():
    """(specs, per-rank results) of every model, one spawn."""
    specs = [_spec(i) for i in range(len(MODELS))]
    return specs, spawn(__import__("_shard_ranks").run_case,
                        make_test_mesh(2, 2), backend="gloo", device="cpu",
                        args=(specs,), timeout_s=300)


def _close(got, want, tol, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = want.detach().double().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1 + np.abs(want))
    assert float(err.max()) <= tol, f"{what}: {float(err.max()):.3e}"


def _mesh(spec):
    return make_test_mesh(*(spec["mesh"] or (2, 2)))


def _blocks(results, key, tick=None):
    """The batch blocks of ``key`` from the ranks at model index 0, in
    data order, after checking every model rank holds the same bits."""
    by_data = {}
    for r in results:
        v = r[key] if tick is None else r[key][tick]
        d = r["coord"][0]
        if d in by_data:
            assert torch.equal(by_data[d], v), (key, r["coord"])
        else:
            by_data[d] = v
    return torch.cat([by_data[d] for d in sorted(by_data)])


def _unsharded(spec):
    cfg = config(configs, spec["arch"], spec["changes"])
    dtype = torch.float64 if spec["dtype"] == "float64" else torch.float32
    model = Model(cfg, device="cpu", params=model_params_from_arrays(
        cfg, spec["tree"], device="cpu")).to(dtype)
    kw = {k: torch.from_numpy(v).to(dtype) for k, v in spec["inputs"].items()}
    return cfg, model, kw


def _reference_logits(spec):
    """The reference's single-device forward logits on the spec's weights
    and inputs (float64 under JAX's 64-bit mode for a float64 spec)."""
    cfg = config(ref_configs, spec["arch"], spec["changes"])
    x64 = spec["dtype"] == "float64"
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), spec["tree"])
        kw = {k: jnp.asarray(v, dt) for k, v in spec["inputs"].items()}
        logits, _, _ = RefModel(cfg).forward(
            params, jnp.asarray(spec["tokens"][:, :spec["prompt"]]), **kw)
        return np.asarray(logits)


@pytest.mark.parametrize("i", range(len(MODELS)), ids=IDS)
def test_sharded_forward_matches_unsharded_and_reference(runs, i):
    specs, ranks = runs
    spec, results = specs[i], [r[i] for r in ranks]
    cfg, model, kw = _unsharded(spec)
    mesh = _mesh(spec)
    toks = torch.from_numpy(spec["tokens"])
    s = spec["prompt"]
    got = _blocks(results, "logits")
    with torch.no_grad():
        want, want_aux, _ = model(toks[:, :s], **kw)
        _close(got, want, TOL_PORT, "logits")
        if cfg.encoder is not None:
            _close(_blocks(results, "encode"), model.encode(kw["frames"]),
                   TOL_PORT, "encoder output")
        body = MODELS[i][7]
        assert set(results[0]["bodies"]) == ({body} if body else set())
        if body in ("expert", "tensor"):
            # dispatch and the balance loss stay within a data block
            n = mesh.shape["data"]
            want_aux = sum(model(blk)[1] for blk in toks[:, :s].chunk(n)) / n
        for r in results:
            _close(r["aux"], want_aux, TOL_PORT, "balance loss")
    _close(got, _reference_logits(spec), TOL_REF, "logits vs reference")


@pytest.mark.parametrize("i", [i for i, m in enumerate(MODELS) if m[4]],
                         ids=[d for d, m in zip(IDS, MODELS) if m[4]])
def test_sharded_cache_and_decode_match_unsharded(runs, i):
    specs, ranks = runs
    spec, results = specs[i], [r[i] for r in ranks]
    cfg, model, kw = _unsharded(spec)
    mesh = _mesh(spec)
    rules = AxisRules(mesh=mesh, fsdp=spec["fsdp"])
    toks = torch.from_numpy(spec["tokens"])
    s, c = spec["prompt"], spec["cache_len"]
    with torch.no_grad():
        want, cache = make_prefill_step(model, c)({"tokens": toks[:, :s],
                                                   **kw})
        _close(_blocks(results, "prefill"), want, TOL_PORT, "prefill step")
        got = gather_tree([r["cache"] for r in results],
                          cache_pspecs(cfg, rules, BATCH, c), mesh)
        assert set(got) == set(cache)
        for key in cache:
            if key == "pos":
                assert torch.equal(got[key], cache[key])
            else:
                _close(got[key], cache[key], TOL_PORT, f"cache {key}")
        for t in range(TICKS):
            want, cache = model.decode_step(cache, toks[:, s + t:s + t + 1])
            _close(_blocks(results, "ticks", t), want, TOL_PORT,
                   f"tick {t}")


@pytest.mark.parametrize("i", [i for i, m in enumerate(MODELS) if m[4]],
                         ids=[d for d, m in zip(IDS, MODELS) if m[4]])
def test_step_collectives_equal_the_tally(runs, i):
    """What every rank's collectives recorded in the prefill step and in
    each tick is ``step_collectives``'s count: op, axes, shape, bytes, in
    order."""
    specs, ranks = runs
    spec = specs[i]
    cfg = config(configs, spec["arch"], spec["changes"])
    rules = AxisRules(mesh=_mesh(spec), fsdp=spec["fsdp"])
    dtype = torch.float64 if spec["dtype"] == "float64" else torch.float32
    n_pos = spec["prompt"] + (cfg.vision.num_patches if cfg.vision else 0)
    pre = collectives.step_collectives(
        cfg, RunShape("p", n_pos, BATCH, "prefill"), rules, dtype=dtype,
        cache_len=spec["cache_len"])
    dec = collectives.step_collectives(
        cfg, RunShape("d", spec["cache_len"], BATCH, "decode"), rules,
        dtype=dtype)
    assert pre and dec
    for r in ranks:
        assert r[i]["prefill_tally"] == pre
        assert all(tally == dec for tally in r[i]["tick_tallies"])


def test_context_parallel_cache_is_refused(runs):
    """paligemma-3b's one KV head does not divide ``model``: its cache
    would split its sequence dim (the next slice), so the forward with a
    cache, ``init_cache`` and ``decode_step`` raise on every rank, while
    its prefill logits are checked above."""
    specs, ranks = runs
    i = [s["arch"] for s in specs].index("paligemma-3b")
    for r in ranks:
        assert len(r[i]["refused"]) == 3
        assert all(m is not None and "context-parallel decode cache" in m
                   for m in r[i]["refused"]), r[i]["refused"]
