"""The port's paligemma (the vision prefix: projected patch embeddings
before the text, attended to under the prefix-LM mask) against the JAX
package's, at ``reduced()`` (2 layers, d_model 256, 8 patches of 64) on
the JAX ``Model.init`` weights bridged with
``interop.model_params_from_arrays`` and seeded numpy patches (x 0.02, as
``tests/test_models_smoke.py`` draws them) and tokens: ``forward(patches=
...)`` with its whole cache, three ``decode_step``s, a batch with an
empty slot and the serving steps, each within ``test_torch_models.py``'s
5e-4 relative tolerance; the prefix-LM mask against the reference's
``_mask_bias``; the published tree and its parameter count; the decode
kernel's plan at paligemma's head dim, 256.

Every comparison runs in float32, as ``test_torch_models.py``'s do.
paligemma's K projection draws from N(0, 1) (its fan-in is the one KV
head), so at this size K/V entries reach ~60; the largest gap between
the two packages, 3.4e-4 x (1 + |x|) in the window case's K cache after
its second decode step, stays under the tolerance, so these tests need
no float64 run (``test_torch_whisper.py``'s do).  The prefill's
prefix-LM attention runs the plain version, every decode attention the
kernel's plain version (the CPU path)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import layers as ref_layers
from repro.serving.steps import make_prefill_step as ref_prefill
from repro.serving.steps import make_serve_step as ref_serve
from repro_torch.configs import get_config, param_count
from repro_torch.interop import model_params_from_arrays
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.models import Model, layers
from repro_torch.models.model import param_descs
from repro_torch.models.params import ParamDesc, count_params
from repro_torch.serving.steps import make_prefill_step, make_serve_step
from test_torch_models import _close, _pair, _same_cache

ARCH = "paligemma-3b"


def _patches(cfg, batch, seed):
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.vision.num_patches, cfg.vision.embed_dim))
        * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


# (changes to the reduced config, prompt length, cache_len): a cache that
# holds the prefix, the prompt and the decoded tokens; one shorter than
# prefix + prompt, which keeps the last C positions and loses prefix rows
# as the reference's does; a window, which the prefix stays inside
SCHEDULES = {"full": ({}, 9, 20), "short_cache": ({}, 9, 12),
             "window": ({"sliding_window": 6}, 9, 20)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_forward_cache_and_decode_match_reference(schedule):
    changes, s, cache_len = SCHEDULES[schedule]
    ref, params, port = _pair(ARCH, **changes)
    toks = np.random.default_rng(2).integers(
        0, ref.cfg.vocab, (2, s + 3)).astype(np.int32)
    patches = _patches(ref.cfg, 2, 3)
    want, want_aux, want_cache = ref.forward(
        params, jnp.asarray(toks[:, :s]), patches=jnp.asarray(patches),
        return_cache=True, cache_len=cache_len)
    got, aux, cache = port(torch.from_numpy(toks[:, :s]),
                           patches=torch.from_numpy(patches),
                           return_cache=True, cache_len=cache_len)
    assert float(aux) == float(want_aux) == 0.0
    assert got.shape == (2, ref.cfg.vision.num_patches + s, ref.cfg.vocab)
    assert int(cache["pos"][0]) == ref.cfg.vision.num_patches + s
    _close(got, want, "forward logits")
    _same_cache(cache, want_cache, "prefill")
    for t in range(s, s + 3):
        want, want_cache = ref.decode_step(params, want_cache,
                                           jnp.asarray(toks[:, t:t + 1]))
        got, cache = port.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]))
        _close(got, want, f"decode step at position {t}")
        _same_cache(cache, want_cache, f"decode step at position {t}")


def test_batch_with_empty_slot_matches_reference(pair):
    """Two requests, each with its image, spliced into an ``init_cache``
    batch of three, the last slot empty (pos -1, no valid cache
    position).  The live rows equal the reference's; the empty row is
    finite."""
    ref, params, port = pair
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, ref.cfg.vocab, (2, 7)).astype(np.int32)
    patches = _patches(ref.cfg, 2, 5)
    want_cache = ref.init_cache(3, 24, dtype=jnp.float32)
    cache = port.init_cache(3, 24, dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in want_cache.items()}
    for slot in range(2):
        one_toks = prompts[slot:slot + 1]
        one_patches = patches[slot:slot + 1]
        _, _, one = ref.forward(params, jnp.asarray(one_toks),
                                patches=jnp.asarray(one_patches),
                                return_cache=True, cache_len=24)
        want_cache = jax.tree.map(
            lambda big, o, i=slot: big.at[i].set(o[0]) if big.ndim == 1
            else big.at[:, :, i].set(o[:, :, 0]), want_cache, one)
        _, _, one = port(torch.from_numpy(one_toks),
                         patches=torch.from_numpy(one_patches),
                         return_cache=True, cache_len=24)
        for key, big in cache.items():
            if key == "pos":
                big[slot] = one[key][0]
            else:
                big[:, :, slot] = one[key][:, :, 0]
    toks = np.concatenate([prompts[:, -1:], [[0]]]).astype(np.int32)
    for _ in range(2):
        want, want_cache = ref.decode_step(params, want_cache,
                                           jnp.asarray(toks))
        got, cache = port.decode_step(cache, torch.from_numpy(toks))
        _close(got[:2], want[:2], "live rows")
        assert torch.isfinite(got).all()
        toks = np.array(jnp.argmax(want, axis=-1), np.int32)[:, None]


def test_steps_match_reference(pair):
    """``make_prefill_step`` on a batch with patches, then three greedy
    ``make_serve_step``s with equal tokens."""
    ref, params, port = pair
    toks = np.random.default_rng(6).integers(
        0, ref.cfg.vocab, (2, 6)).astype(np.int32)
    patches = _patches(ref.cfg, 2, 7)
    want, want_cache = ref_prefill(ref, cache_len=18)(
        params, {"tokens": jnp.asarray(toks),
                 "patches": jnp.asarray(patches)})
    got, cache = make_prefill_step(port, cache_len=18)(
        {"tokens": torch.from_numpy(toks),
         "patches": torch.from_numpy(patches)})
    _close(got, want, "prefill step")
    nxt = np.array(jnp.argmax(want, -1), np.int32)[:, None]
    for _ in range(3):
        w, want_cache = ref_serve(ref)(params, want_cache,
                                       {"tokens": jnp.asarray(nxt)})
        g, cache = make_serve_step(port)(cache,
                                         {"tokens": torch.from_numpy(nxt)})
        _close(g["logits"], w["logits"], "serve step")
        np.testing.assert_array_equal(g["next_token"].numpy(),
                                      np.asarray(w["next_token"]))
        nxt = np.array(w["next_token"])[:, None]


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("prefix_len", [3, 8])
def test_prefix_mask_matches_reference(prefix_len, window):
    """The mask the prefill's attention applies, read off its output:
    with q = 0 every allowed key weighs the same, and with V the identity
    (key j's row is unit vector j) the output row is the mask over its
    count.  It equals the reference's ``_mask_bias`` (0 where allowed) at
    ``prefix_len`` > 0, with and without a window; the attention itself
    equals the reference's ``gqa_attention`` on random operands."""
    s, kh, g = 12, 1, 2
    q = torch.zeros((1, s, kh * g, s))
    k = torch.zeros((1, s, kh, s))
    v = torch.eye(s)[None, :, None, :].expand(1, s, kh, s).contiguous()
    out = layers.gqa_attention(q, k, v, causal=True, window=window,
                               prefix_len=prefix_len)
    pos = jnp.arange(s)
    bias = np.asarray(ref_layers._mask_bias(pos, pos, causal=True,
                                            window=window,
                                            prefix_len=prefix_len))
    np.testing.assert_array_equal(out[0, :, 0].numpy() > 0, bias == 0)
    np.testing.assert_allclose(out[0, :, 0].numpy().sum(-1), 1.0, rtol=1e-6)
    rng = np.random.default_rng(prefix_len)
    qr, kr, vr = (rng.standard_normal(shape).astype(np.float32)
                  for shape in ((2, s, kh * g, 8), (2, s, kh, 8),
                                (2, s, kh, 8)))
    want = ref_layers.gqa_attention(
        jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(vr), pos, pos,
        causal=True, window=window, prefix_len=prefix_len)
    got = layers.gqa_attention(*(torch.from_numpy(a) for a in (qr, kr, vr)),
                               causal=True, window=window,
                               prefix_len=prefix_len)
    _close(got, want, "prefix-LM attention")


def test_forward_without_patches_raises(pair):
    _, _, port = pair
    with pytest.raises(ValueError, match="patches"):
        port(torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="patches"):
        make_prefill_step(port)({"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)})


def test_bridge_carries_the_vision_projector(pair):
    """The JAX tree, its ``vision_proj`` included, crosses unchanged; a
    wrong projector shape and a missing projector are refused."""
    ref, params, port = pair
    cfg = port.cfg
    tree = jax.tree.map(np.asarray, params)
    got = model_params_from_arrays(cfg, tree, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert tuple(got["vision_proj"].shape) == (cfg.vision.embed_dim,
                                               cfg.d_model)
    tree["vision_proj"] = tree["vision_proj"][:-1]
    with pytest.raises(ValueError, match="vision_proj"):
        model_params_from_arrays(cfg, tree, device="cpu")
    del tree["vision_proj"]
    with pytest.raises(ValueError, match="keys"):
        model_params_from_arrays(cfg, tree, device="cpu")


def test_published_paligemma_tree():
    """paligemma-3b's published parameter tree (descriptors only: no
    weights drawn): 3,037,800,448 parameters, the config's analytic count,
    the 1152 x 2048 projector included; every leaf shaped as the
    reference's."""
    cfg = get_config(ARCH)
    descs = param_descs(cfg)
    assert descs["vision_proj"].shape == (1152, 2048)
    assert descs["groups"]["pos0"]["mixer"]["wk"].shape == (18, 2048, 1, 256)
    assert count_params(descs) == param_count(cfg) == 3_037_800_448
    got = jax.tree_util.tree_flatten_with_path(
        descs, is_leaf=lambda d: isinstance(d, ParamDesc))[0]
    want = jax.tree_util.tree_flatten_with_path(
        RefModel(ref_get_config(ARCH)).shapes())[0]
    assert [(path, d.shape) for path, d in got] == [
        (path, a.shape) for path, a in want]


def test_published_model_forward_shapes():
    """``Model`` at the published config, its parameters on the meta
    device (shapes only, nothing drawn): a prefill of 2 x (256 patches +
    5 tokens) gives 261 rows of logits and a cache of every position."""
    cfg = get_config(ARCH)

    def meta(tree):
        return {k: meta(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else torch.empty(tree.shape,
                                                       device="meta")
    model = Model(cfg, device="meta", params=meta(param_descs(cfg)))
    logits, _, cache = model(
        torch.zeros((2, 5), dtype=torch.int32, device="meta"),
        patches=torch.empty((2, 256, 1152), device="meta"),
        return_cache=True, cache_len=300)
    assert logits.shape == (2, 261, 257_216)
    assert cache["k"].shape == (18, 1, 2, 300, 1, 256)


H100_SMS = 132


@pytest.mark.parametrize("dtype,smem,per_sm", [
    (torch.float32, 147_060, 1), (torch.bfloat16, 81_524, 2)])
def test_decode_plan_at_head_dim_256(dtype, smem, per_sm):
    """paligemma's served decode, (B, KH, G, hd, C) = (4, 1, 8, 256, 512):
    a tile of all 8 query heads, 16 chunks of one 32-position tile, two
    ring stages (three leave no room for the plan's three resident
    blocks), one block an SM in float32 and two in bfloat16."""
    plan = decode_ops.decode_plan(4, 1, 8, 512, 256, H100_SMS, dtype=dtype)
    assert (plan.gt, plan.n_gtiles, plan.chunk, plan.n_chunks,
            plan.stages, plan.smem) == (8, 1, 32, 16, 2, smem)
    assert plan.smem <= decode_ops.SMEM_LIMIT
    assert decode_ops.SM_SMEM // (plan.smem + 1024) == per_sm
    assert plan.workspace_floats(4, 1, 256) == 4 * 16 * 8 * 258
