"""The port's whisper (encoder-decoder: the encoder, cross-attention and
absolute sinusoidal positions) against the JAX package's, at
``reduced()`` (2 + 2 layers, d_model 256, src_len 16) on the JAX
``Model.init`` weights bridged with ``interop.model_params_from_arrays``
and seeded numpy frames (x 0.02, as ``tests/test_models_smoke.py`` draws
them) and tokens: ``encode``, the three cross-attention functions,
``forward(frames=...)`` with its whole cache (``ck``/``cv`` included),
three ``decode_step``s, a batch with an empty slot and the serving steps,
each within ``test_torch_models.py``'s 5e-4 relative tolerance.

The whole-model comparisons (forward, cache, decode steps, the empty
slot) run both sides in float64 on the float32 weights (the reference
under ``jax.enable_x64``, where it still takes its norms and attention
scores in float32).  Whisper at this size has attention outputs of ~50
and K/V entries of ~30, and four attention sublayers a decoder layer
deep amplify a float32 rounding: the reference's own float32 K/V are
2e-4 to 6e-4 from float64, as far as the tolerance allows at an entry
near 0.  In float64 the port stays within a third of the tolerance.
The steps, ``encode`` and the cross-attention functions compare in
float32.  The encoder's and the prefill's cross-attention run the plain
non-causal attention, the decoder's self-attention and every decode
attention the kernels' plain versions (the CPU path)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.serving.steps import make_prefill_step as ref_prefill
from repro.serving.steps import make_serve_step as ref_serve
from repro.sharding.specs import AxisRules
from repro_torch.configs import get_config, reduced
from repro_torch.interop import model_params_from_arrays
from repro_torch.models import attention
from repro_torch.models import model as model_mod
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.models.model import PE_ROWS, decode_positions, param_descs
from repro_torch.models.params import ParamDesc
from repro_torch.serving.steps import make_prefill_step, make_serve_step
from repro_torch.sharding.specs import DEFAULT_RULES
from test_torch_models import SCHEDULES, _close, _pair, _same_cache

ARCH = "whisper-small"


def _frames(cfg, batch, seed):
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder.src_len, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


@contextlib.contextmanager
def _x64(arch_changes):
    """(JAX model, its params, port model) on the float32 weights of
    ``_pair``, both sides in float64, JAX's 64-bit mode on within."""
    ref, params, port = _pair(ARCH, **arch_changes)
    with jax.enable_x64(True):
        yield (ref, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 params), port.double())


def test_encode_matches_reference(pair):
    ref, params, port = pair
    frames = _frames(ref.cfg, 2, 0)
    _close(port.encode(torch.from_numpy(frames)),
           ref.encode(params, jnp.asarray(frames)), "encoder output")


def _cross_operands(ref, params, port):
    """The first decoder layer's cross-attention parameters on both sides,
    a (2, 5, D) decoder input and a (2, src_len, D) encoder output."""
    p_ref = jax.tree.map(lambda a: a[0], params["groups"]["pos0"]["cross"])
    p = {k: v[0] for k, v in
         port.params.tree()["groups"]["pos0"]["cross"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, ref.cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, ref.cfg.encoder.src_len,
                               ref.cfg.d_model)).astype(np.float32)
    return p_ref, p, x, src


@pytest.mark.parametrize("fn", ["cross_attn_forward", "cross_attn_cache",
                                "cross_attn_decode"])
def test_cross_attention_matches_reference(pair, fn):
    ref, params, port = pair
    p_ref, p, x, src = _cross_operands(ref, params, port)
    rules = AxisRules()
    if fn == "cross_attn_forward":
        want = ref_attention.cross_attn_forward(
            p_ref, jnp.asarray(x), jnp.asarray(src), ref.cfg, rules)
        _close(attention.cross_attn_forward(
            p, torch.from_numpy(x), attention.cross_attn_cache(
                p, torch.from_numpy(src), port.cfg, DEFAULT_RULES), port.cfg,
            DEFAULT_RULES), want, fn)
        return
    want_cache = ref_attention.cross_attn_cache(p_ref, jnp.asarray(src))
    cache = attention.cross_attn_cache(p, torch.from_numpy(src), port.cfg,
                                       DEFAULT_RULES)
    if fn == "cross_attn_cache":
        assert set(cache) == set(want_cache) == {"k", "v"}
        for key in cache:
            _close(cache[key], want_cache[key], f"{fn} {key}")
        return
    want = ref_attention.cross_attn_decode(p_ref, jnp.asarray(x[:, :1]),
                                           want_cache, rules)
    _close(attention.cross_attn_decode(p, torch.from_numpy(x[:, :1]),
                                       cache, port.cfg, DEFAULT_RULES), want,
           fn)


@pytest.mark.parametrize("schedule", ["full", "long_prompt"])
def test_forward_cache_and_decode_match_reference(schedule):
    changes, s, cache_len = SCHEDULES[schedule]
    with _x64(changes) as (ref, params, port):
        toks = np.random.default_rng(2).integers(
            0, ref.cfg.vocab, (2, s + 3)).astype(np.int32)
        frames = _frames(ref.cfg, 2, 3).astype(np.float64)
        want, want_aux, want_cache = ref.forward(
            params, jnp.asarray(toks[:, :s]), frames=jnp.asarray(frames),
            return_cache=True, cache_len=cache_len)
        got, aux, cache = port(torch.from_numpy(toks[:, :s]),
                               frames=torch.from_numpy(frames),
                               return_cache=True, cache_len=cache_len)
        assert float(aux) == float(want_aux) == 0.0
        assert {"ck", "cv"} <= set(cache)
        _close(got, want, "forward logits")
        _same_cache(cache, want_cache, "prefill")
        for t in range(s, s + 3):
            want, want_cache = ref.decode_step(
                params, want_cache, jnp.asarray(toks[:, t:t + 1]))
            got, cache = port.decode_step(cache, torch.from_numpy(
                toks[:, t:t + 1]))
            _close(got, want, f"decode step at position {t}")
            _same_cache(cache, want_cache, f"decode step at position {t}")


def test_batch_with_empty_slot_matches_reference(monkeypatch):
    """Two requests spliced into an ``init_cache`` batch of three, the
    last slot empty: its pos is -1, so its decode step adds the last row
    of the reference's 65,536-row table.  Every row, the empty one
    included, equals the reference's.  The decode steps add the
    reference's own table rows here: XLA's float32 ``exp`` is one ulp
    off torch's in some of the table's frequencies, which moves row
    65,535 by 1.2e-4 (the rows' rule and values are
    ``test_decode_positions_follow_the_reference``'s)."""
    table = np.asarray(ref_layers.sinusoidal_positions(
        PE_ROWS, reduced(get_config(ARCH)).d_model))
    monkeypatch.setattr(model_mod, "decode_positions",
                        lambda pos, dim: torch.from_numpy(table[pos.numpy()]))
    with _x64({}) as (ref, params, port):
        rng = np.random.default_rng(4)
        prompts = rng.integers(0, ref.cfg.vocab, (2, 7)).astype(np.int32)
        frames = _frames(ref.cfg, 2, 5).astype(np.float64)
        want_cache = ref.init_cache(3, 12, dtype=jnp.float64)
        cache = port.init_cache(3, 12, dtype=torch.float64)
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: v.shape for k, v in want_cache.items()}
        for slot in range(2):
            one_toks = prompts[slot:slot + 1]
            one_frames = frames[slot:slot + 1]
            _, _, one = ref.forward(params, jnp.asarray(one_toks),
                                    frames=jnp.asarray(one_frames),
                                    return_cache=True, cache_len=12)
            want_cache = jax.tree.map(
                lambda big, o, i=slot: big.at[i].set(o[0]) if big.ndim == 1
                else big.at[:, :, i].set(o[:, :, 0]), want_cache, one)
            _, _, one = port(torch.from_numpy(one_toks),
                             frames=torch.from_numpy(one_frames),
                             return_cache=True, cache_len=12)
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
            _close(got, want, "every row, the empty slot's included")
            _same_cache(cache, want_cache, "decode step")
            toks = np.array(jnp.argmax(want, axis=-1), np.int32)[:, None]


def test_decode_positions_follow_the_reference():
    """The decode step's rows, computed directly, are the rows the
    reference indexes from its whole table (as jnp indexes: an empty
    slot's -1 reads the last row, a position past the end the last), and
    the table's rows at whisper's positions equal the reference's."""
    dim = 64
    pos = np.array([0, 1, 7, 447, 1499, 40_000, PE_ROWS - 1, -1, -2,
                    PE_ROWS + 5], np.int32)
    rows = np.asarray(jnp.arange(PE_ROWS)[jnp.asarray(pos)])
    np.testing.assert_array_equal(
        decode_positions(torch.from_numpy(pos), dim).numpy(),
        sinusoidal_positions(PE_ROWS, dim).numpy()[rows])
    np.testing.assert_allclose(
        sinusoidal_positions(1500, dim).numpy(),
        np.asarray(ref_layers.sinusoidal_positions(1500, dim)), rtol=0,
        atol=1e-5)


def test_steps_match_reference(pair):
    """``make_prefill_step`` on a batch with frames, then three greedy
    ``make_serve_step``s with equal tokens."""
    ref, params, port = pair
    toks = np.random.default_rng(6).integers(
        0, ref.cfg.vocab, (2, 6)).astype(np.int32)
    frames = _frames(ref.cfg, 2, 7)
    want, want_cache = ref_prefill(ref, cache_len=10)(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    got, cache = make_prefill_step(port, cache_len=10)(
        {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)})
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


def test_forward_without_frames_raises(pair):
    _, _, port = pair
    with pytest.raises(ValueError, match="frames"):
        port(torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="frames"):
        make_prefill_step(port)({"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32)})


def test_batch_with_patches_raises(pair):
    """Patches given to a config without a vision prefix are refused (the
    reference ignores them)."""
    _, _, port = pair
    frames = torch.zeros((1, port.cfg.encoder.src_len, port.cfg.d_model))
    with pytest.raises(ValueError, match="patches"):
        make_prefill_step(port)({"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int32),
                                 "frames": frames,
                                 "patches": torch.zeros((1, 8, 64))})


def test_bridge_carries_the_whisper_tree(pair):
    """The JAX tree, its encoder included, crosses unchanged; a wrong
    encoder shape and a missing cross-attention are refused."""
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
    assert tuple(got["encoder"]["layers"]["attn"]["wq"].shape) == (
        cfg.encoder.num_layers, cfg.d_model, cfg.num_heads, cfg.hd)
    tree["encoder"]["layers"]["ffn"]["w_up"] = tree["encoder"]["layers"][
        "ffn"]["w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="w_up"):
        model_params_from_arrays(cfg, tree, device="cpu")
    del tree["groups"]["pos0"]["cross"]
    with pytest.raises(ValueError, match="keys"):
        model_params_from_arrays(cfg, tree, device="cpu")


def test_published_whisper_tree():
    """whisper-small's published parameter tree (descriptors only: no
    weights drawn): 12 encoder layers at hd 64 with QKV bias, a
    cross-attention in each decoder layer, every leaf shaped as the
    reference's."""
    descs = param_descs(get_config(ARCH))
    assert descs["encoder"]["layers"]["attn"]["bq"].shape == (12, 12, 64)
    assert descs["groups"]["pos0"]["cross"]["wk"].shape == (12, 768, 12, 64)
    got = jax.tree_util.tree_flatten_with_path(
        descs, is_leaf=lambda d: isinstance(d, ParamDesc))[0]
    want = jax.tree_util.tree_flatten_with_path(
        RefModel(ref_get_config(ARCH)).shapes())[0]
    assert [(path, d.shape) for path, d in got] == [
        (path, a.shape) for path, a in want]
