"""The port's LM stack against the JAX package's on the same weights: for
``tinyllama-1.1b``, ``qwen2.5-3b``, ``falcon-mamba-7b`` and the three
mixture-of-experts configs (``mixtral-8x7b``, ``qwen3-moe-235b-a22b``,
``jamba-v0.1-52b``, the last also with its experts replaced by the dense
FFN) at ``reduced()`` (and the other dense configs, ``llama3-8b`` and
``granite-20b``, the latter also with its published 48 query heads to
one KV head), the JAX ``Model.init`` weights bridged with
``interop.model_params_from_arrays`` and the same tokens give the same
``forward`` logits, the same cache and the same logits and caches over
three ``decode_step``s, and the same MoE balance loss, within 5e-4 (the
reference's own decode-vs-prefill
bound, ``tests/test_models_smoke.py:72``) relative to the value's size:
|got - want| <= 5e-4 (1 + |want|).  The reference's initialisers give
activations, K/V cache entries and attention scores of 10-100, where
float32 sums taken in another order (torch's and XLA's matrix products)
differ by a few 1e-5 of the value and the softmax passes that on; the
same rounding in values of 1 stays under 5e-4 absolute.  The attention
and scan run through the kernels' plain versions (the CPU path)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import mamba as ref_mamba
from repro.sharding.specs import AxisRules
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.interop import model_params_from_arrays
from repro_torch.models import Model, mamba
from repro_torch.serving.steps import make_prefill_step, make_serve_step

ARCHS = ["tinyllama-1.1b", "qwen2.5-3b", "falcon-mamba-7b", "mixtral-8x7b",
         "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
TOL = 5e-4


def _pair(arch, **changes):
    """(JAX model, its params, port model) on the same weights."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    ref = RefModel(ref_cfg)
    params = ref.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    port = Model(cfg, device="cpu",
                 params=model_params_from_arrays(cfg, tree, device="cpu"))
    return ref, params, port


def _close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _same_cache(got, want, what):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, (what, key)
        if key == "pos":
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            _close(got[key], want[key], f"{what}: cache {key}")


# (changes to the reduced config, prompt length, cache_len): a full cache,
# a rotating window the second decode step wraps around, and a prompt
# longer than the window (the prefill cache's rotation)
SCHEDULES = {"full": ({}, 9, 16), "window": ({"sliding_window": 10}, 9, 16),
             "long_prompt": ({"sliding_window": 8}, 12, 16),
             # jamba's attention + 7 Mamba period, its experts replaced by
             # the dense FFN
             "no_experts": ({"moe": None}, 9, 16),
             # granite's published grouping: 48 query heads to one KV head
             "mqa_48": ({"num_heads": 48, "head_dim": 32}, 9, 16)}


# falcon-mamba is attention-free: a sliding window changes nothing there
CASES = [(arch, sched) for arch in ARCHS for sched in sorted(SCHEDULES)
         if sched not in ("no_experts", "mqa_48")
         and (arch != "falcon-mamba-7b" or sched == "full")] + [
    ("jamba-v0.1-52b", "no_experts"), ("llama3-8b", "full"),
    ("granite-20b", "full"), ("granite-20b", "mqa_48")]


@pytest.mark.parametrize("arch,schedule", CASES)
def test_forward_cache_and_decode_match_reference(arch, schedule):
    changes, s, cache_len = SCHEDULES[schedule]
    ref, params, port = _pair(arch, **changes)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, ref.cfg.vocab, (2, s + 3)).astype(np.int32)
    want, want_aux, want_cache = ref.forward(
        params, jnp.asarray(toks[:, :s]), return_cache=True,
        cache_len=cache_len)
    got, aux, cache = port(torch.from_numpy(toks[:, :s]), return_cache=True,
                           cache_len=cache_len)
    if port.cfg.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        _close(aux, want_aux, "MoE aux")
    _close(got, want, "forward logits")
    _same_cache(cache, want_cache, "prefill")
    for t in range(s, s + 3):
        want, want_cache = ref.decode_step(params, want_cache,
                                           jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]))
        _close(got, want, f"decode step at position {t}")
        _same_cache(cache, want_cache, f"decode step at position {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_with_empty_slot_matches_reference(arch):
    """A served batch: two requests spliced into an ``init_cache`` batch
    of three, the last slot empty (pos -1, no valid cache position).  The
    live rows equal the reference's; the empty row is finite."""
    ref, params, port = _pair(arch)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, ref.cfg.vocab, (2, 7)).astype(np.int32)
    want_cache = ref.init_cache(3, 12, dtype=jnp.float32)
    cache = port.init_cache(3, 12, dtype=torch.float32)
    for slot in range(2):
        _, _, one = ref.forward(params, jnp.asarray(prompts[slot:slot + 1]),
                                return_cache=True, cache_len=12)
        want_cache = jax.tree.map(
            lambda big, o, i=slot: big.at[i].set(o[0]) if big.ndim == 1
            else big.at[:, :, i].set(o[:, :, 0]), want_cache, one)
        _, _, one = port(torch.from_numpy(prompts[slot:slot + 1]),
                         return_cache=True, cache_len=12)
        for key, big in cache.items():
            if key == "pos":
                big[slot] = one[key][0]
            else:
                big[:, :, slot] = one[key][:, :, 0]
    toks = np.concatenate([prompts[:, -1:], [[0]]]).astype(np.int32)
    toks.setflags(write=True)
    for _ in range(2):
        want, want_cache = ref.decode_step(params, want_cache,
                                           jnp.asarray(toks))
        got, cache = port.decode_step(cache, torch.from_numpy(toks))
        _close(got[:2], want[:2], "live rows")
        assert torch.isfinite(got).all()
        toks = np.array(jnp.argmax(want, axis=-1), np.int32)[:, None]


def test_mamba_forward_matches_reference():
    """The sublayer the scan kernel sits in, alone: ``mamba_forward``'s
    output and its decode state (the scan's last state, the conv
    window)."""
    ref, params, port = _pair("falcon-mamba-7b")
    x = np.random.default_rng(3).standard_normal(
        (2, 11, ref.cfg.d_model)).astype(np.float32)
    p_ref = jax.tree.map(lambda a: a[0], params["groups"]["pos0"]["mixer"])
    p = {k: v[0] for k, v in
         port.params.tree()["groups"]["pos0"]["mixer"].items()}
    want, (h, conv) = ref_mamba.mamba_forward(
        p_ref, jnp.asarray(x), ref.cfg, AxisRules(), return_state=True)
    got, (h_got, conv_got) = mamba.mamba_forward(
        p, torch.from_numpy(x), port.cfg, return_state=True)
    _close(got, want, "mixer output")
    _close(h_got, h, "last state")
    _close(conv_got, conv, "conv state")


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_match_reference(arch):
    """``make_prefill_step`` then two greedy ``make_serve_step``s."""
    from repro.serving.steps import make_prefill_step as ref_prefill
    from repro.serving.steps import make_serve_step as ref_serve
    ref, params, port = _pair(arch)
    toks = np.random.default_rng(4).integers(
        0, ref.cfg.vocab, (2, 6)).astype(np.int32)
    want, want_cache = ref_prefill(ref, cache_len=10)(
        params, {"tokens": jnp.asarray(toks)})
    got, cache = make_prefill_step(port, cache_len=10)(
        {"tokens": torch.from_numpy(toks)})
    _close(got, want, "prefill step")
    nxt = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    for _ in range(2):
        w, want_cache = ref_serve(ref)(params, want_cache,
                                       {"tokens": jnp.asarray(nxt)})
        g, cache = make_serve_step(port)(cache,
                                         {"tokens": torch.from_numpy(nxt)})
        _close(g["logits"], w["logits"], "serve step")
        np.testing.assert_array_equal(g["next_token"].numpy(),
                                      np.asarray(w["next_token"]))
        nxt = np.array(w["next_token"])[:, None]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_prefill(arch):
    """The port's own consistency: the last decode step's logits equal the
    full forward's at that position (the reference's bound); whisper's
    with the same frames on both, paligemma's with the same patches (its
    cache holds the prefix too)."""
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)).astype(
        np.int32))
    kw, prefix = {}, 0
    if cfg.encoder is not None:
        kw["frames"] = torch.from_numpy((rng.standard_normal(
            (2, cfg.encoder.src_len, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.vision is not None:
        prefix = cfg.vision.num_patches
        kw["patches"] = torch.from_numpy((rng.standard_normal(
            (2, prefix, cfg.vision.embed_dim)) * 0.02).astype(np.float32))
    full, _, _ = model(toks, **kw)
    _, _, cache = model(toks[:, :8], return_cache=True,
                        cache_len=prefix + 13, **kw)
    logits, _ = model.decode_step(cache, toks[:, 8:9])
    err = (logits - full[:, -1]).abs() / (1 + full[:, -1].abs())
    assert float(err.max()) < TOL


def test_bridge_rejects_a_wrong_tree():
    cfg = reduced(get_config("tinyllama-1.1b"))
    tree = jax.tree.map(np.asarray, RefModel(ref_reduced(ref_get_config(
        "tinyllama-1.1b"))).init(jax.random.PRNGKey(0)))
    tree["groups"]["pos0"]["mixer"]["wq"] = tree["groups"]["pos0"]["mixer"][
        "wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        model_params_from_arrays(cfg, tree, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        model_params_from_arrays(cfg, tree, device="cpu")
