"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``) and the ``msgpack`` package: the port's
own codec packs byte-equal to ``msgpack.packb(use_bin_type=True)`` and
unpacks as ``msgpack.unpackb(raw=True/False)`` does, on every size
boundary; a checkpoint file is byte-equal whichever package writes it and
loads in both; a policy and predictor, and an LM's weights, cross in both
directions and compute what they computed.  Only this test imports
``msgpack``: the port has its own codec."""
import collections

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.core import policy as r_pol
from repro.core import predictor as r_pred
from repro.core.env import obs_dim
from repro.models import Model as RefModel
from repro_torch import interop
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import msgpack as codec
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy as p_pol
from repro_torch.core import predictor as p_pred
from repro_torch.models import Model
from repro_torch.models.model import param_descs

R = 5

# ------------------------------------------------------------------ codec

# each int width at both ends, and fixint's edges
INT_EDGES = (0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 2**32 - 1,
             2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2**31, -2**31 - 1, -2**63)
# lengths at both ends of every length form (fix, 8, 16, 32 bits)
LENGTHS = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)
COUNTS = (0, 1, 15, 16, 65535, 65536)

scalars = (st.none() | st.booleans() | st.sampled_from(INT_EDGES)
           | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=False)
           | st.text(max_size=40) | st.binary(max_size=40)
           | st.sampled_from(LENGTHS).map(lambda n: "s" * n)
           | st.sampled_from(LENGTHS).map(lambda n: b"\x00" * n))
keys = st.text(max_size=8) | st.binary(max_size=8)
payloads = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=18)
                   | st.dictionaries(keys, inner, max_size=18)
                   | st.sampled_from(COUNTS).map(lambda n: [0] * n)
                   | st.sampled_from(COUNTS).map(
                       lambda n: {str(i): i for i in range(n)})),
    max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(payloads)
def test_codec_equals_msgpack(obj):
    packed = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == packed
    for raw in (True, False):
        assert codec.unpackb(packed, raw=raw) == \
            msgpack.unpackb(packed, raw=raw)


@pytest.mark.parametrize("n", INT_EDGES)
def test_codec_int_widths(n):
    packed = msgpack.packb(n)
    assert codec.packb(n) == packed and codec.unpackb(packed) == n


def test_codec_tuples_pack_as_arrays():
    obj = {b"a": (1, (2.5, None)), "b": bytearray(b"xy")}
    assert codec.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert codec.unpackb(codec.packb(obj), raw=True) == \
        {b"a": [1, [2.5, None]], b"b": b"xy"}


PACKED = msgpack.packb({b"step": 3, b"x": [1.5, "é" * 40, b"\x01" * 300,
                                          -70000, None, True]},
                       use_bin_type=True)


@pytest.mark.parametrize("cut", [1, 2, 9, 30, 100, len(PACKED) - 1])
def test_codec_truncated_input_raises(cut):
    with pytest.raises(ValueError):
        msgpack.unpackb(PACKED[:cut])
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(PACKED[:cut])


@pytest.mark.parametrize("data,what", [
    (PACKED + b"\x00", "trailing"), (b"", "truncated"),
    (msgpack.packb(1.5, use_single_float=True), "float32"),
    (msgpack.packb(msgpack.ExtType(1, b"ab")), "ext"),
    (b"\xc7\x01\x05x", "ext"), (b"\xc1", "unused")])
def test_codec_rejects_what_it_does_not_handle(data, what):
    with pytest.raises(ValueError) as err:
        codec.unpackb(data)
    if what in ("trailing", "truncated"):
        assert what in str(err.value)
    else:
        assert "not handled" in str(err.value)


@pytest.mark.parametrize("obj,error", [({1, 2}, TypeError),
                                       (2**64, OverflowError),
                                       (-2**63 - 1, OverflowError),
                                       (1 + 2j, TypeError)])
def test_codec_refuses_what_msgpack_refuses(obj, error):
    with pytest.raises(error):
        msgpack.packb(obj, use_bin_type=True)
    with pytest.raises(error):
        codec.packb(obj)


# ------------------------------------------------------------------ files

NT = collections.namedtuple("NT", "a b")


def _np_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.random((3, 4), np.float32),
                   "b": rng.random(4),
                   "emb": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "bf": rng.random((2, 5)).astype(ml_dtypes.bfloat16)},
        "opt": [np.ones(3, np.float32), None,
                (np.full(2, 7, np.int32), rng.random((1, 2)))],
        "empty": {"x": None, "y": [], "z": ()},
        "scalar": 3, "lr": 0.5,
    }


def _bf16(a):
    return torch.from_numpy(np.asarray(a).view(np.int16)).view(
        torch.bfloat16)


def _torch_tree(tree):
    """The same tree with tensors for arrays (bfloat16 as
    ``torch.bfloat16``)."""
    def conv(x):
        if isinstance(x, np.ndarray):
            return _bf16(x) if x.dtype == ml_dtypes.bfloat16 \
                else torch.from_numpy(x.copy())
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x
    return conv(tree)


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_file_byte_equal_whichever_package_writes(leaves, tmp_path):
    tree = _np_tree()
    want = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 7, tree)
    got = save_checkpoint(tmp_path / "port", 7,
                          tree if leaves == "numpy" else _torch_tree(tree))
    assert got.endswith("ckpt_00000007.msgpack")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert not list((tmp_path / "port").glob("*.tmp"))


TREES = {
    "nested": _np_tree(),
    "policy": {"policy": [{"w": np.ones((2, 3), np.float32), "b": 1.0}],
               "value": [None]},
    "leaf": np.zeros(2), "none": None, "tuple1": (1,), "empty": {},
    "namedtuple": {"nt": NT(np.ones(1), [2, (3,)])},
    "int_keys": {3: 1, 1: [2]},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_flatten_matches_jax(name):
    tree = TREES[name]
    leaves, treedef = flatten(tree)
    want_leaves, want_def = jax.tree.flatten(tree)
    assert treedef == str(want_def)
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        assert a is b


@pytest.mark.parametrize("node", [{1, 2}, object(),
                                  collections.OrderedDict(a=1)])
def test_flatten_refuses_other_nodes(node):
    with pytest.raises(TypeError):
        flatten({"x": node})


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert torch.equal(got, want)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_reference_file_loads_in_port(tmp_path):
    tree = _np_tree()
    ref_ckpt.save_checkpoint(str(tmp_path), 4, tree)
    step, got = load_checkpoint(tmp_path, _torch_tree(tree))
    assert step == 4
    _assert_tree_equal(got, _torch_tree(tree))
    # a numpy template: numpy leaves, bfloat16 read back through float32
    tmpl = _np_tree()
    tmpl["params"]["bf"] = np.zeros((2, 5), np.float32)
    _, got = load_checkpoint(tmp_path, tmpl)
    np.testing.assert_array_equal(got["params"]["bf"],
                                  tree["params"]["bf"].astype(np.float32))
    np.testing.assert_array_equal(got["params"]["b"], tree["params"]["b"])


def test_port_file_loads_in_reference(tmp_path):
    tree = _np_tree()
    save_checkpoint(tmp_path, 9, _torch_tree(tree))
    step, got = ref_ckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 9
    flat_got, def_got = jax.tree.flatten(got)
    flat_want, def_want = jax.tree.flatten(tree)
    assert def_got == def_want
    for a, b in zip(flat_got, flat_want):
        # jax without x64 holds float64 leaves as float32
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b).astype(np.asarray(a).dtype))
    assert got["params"]["bf"].dtype == jnp.bfloat16
    payload = msgpack.unpackb(open(tmp_path / "ckpt_00000009.msgpack",
                                   "rb").read(), raw=True)
    assert payload[b"treedef"] == str(jax.tree.flatten(tree)[1]).encode()


def test_latest_step_and_explicit_step(tmp_path):
    tree = _torch_tree(_np_tree())
    assert latest_step(tmp_path) is None
    assert latest_step(tmp_path / "missing") is None
    for s in (1, 12, 7):
        tree["scalar"] = s
        save_checkpoint(tmp_path, s, tree)
    (tmp_path / "ckpt_00000099.msgpack.bak").write_bytes(b"")
    assert latest_step(tmp_path) == 12
    assert ref_ckpt.latest_step(str(tmp_path)) == 12
    step, got = load_checkpoint(tmp_path, tree)
    assert (step, got["scalar"]) == (12, 12)
    step, got = load_checkpoint(tmp_path, tree, step=7)
    assert (step, got["scalar"]) == (7, 7)


def test_load_casts_to_template_dtype(tmp_path):
    save_checkpoint(tmp_path, 0, {"w": torch.ones((2, 2)),
                                  "i": np.arange(3, dtype=np.int64),
                                  "h": _bf16(np.full(2, 1.5, ml_dtypes.
                                                     bfloat16))})
    template = {"w": torch.zeros((2, 2), dtype=torch.bfloat16),
                "i": torch.zeros(3, dtype=torch.float64),
                "h": torch.zeros(2, dtype=torch.float32)}
    _, got = load_checkpoint(tmp_path, template)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.ones((2, 2)))
    assert got["i"].dtype == torch.float64
    assert got["i"].tolist() == [0.0, 1.0, 2.0]
    assert got["h"].dtype == torch.float32 and got["h"].tolist() == [1.5, 1.5]
    with pytest.raises(ValueError, match="fewer leaves"):
        load_checkpoint(tmp_path, {**template, "z": torch.zeros(1)})
    with pytest.raises(ValueError, match="more leaves"):
        load_checkpoint(tmp_path, {"w": template["w"]})


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_checkpoint(tmp_path / "empty", {"x": np.zeros(1)})
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_checkpoint(tmp_path, {"x": np.zeros(1)})


# ------------------------------------- a policy and a predictor at R = 5


def _ref_nets():
    """The reference's seeded policy (final layer scaled up 100x, so the
    Betas are far from uniform) and predictor, as jax trees."""
    policy = r_pol.init_policy(jax.random.PRNGKey(3), obs_dim(R), R)
    policy["policy"][-1]["w"] = policy["policy"][-1]["w"] * 100
    return policy, r_pred.init_predictor(jax.random.PRNGKey(4), R)


def _inputs():
    rng = np.random.default_rng(2)
    return (rng.random((7, obs_dim(R))).astype(np.float32),
            rng.random((7, p_pred.K_HIST, 3 * R)).astype(np.float32))


def _fresh_port_nets():
    return (p_pol.init_policy(torch.Generator().manual_seed(11),
                              obs_dim(R), R),
            p_pred.init_predictor(torch.Generator().manual_seed(12), R))


def _template():
    pol, pred = _fresh_port_nets()
    return {"policy": interop.policy_params_to_arrays(pol),
            "predictor": interop.predictor_params_to_arrays(pred)}


def _outputs_close(pol_port, pred_port, pol_ref, pred_ref):
    """mean_action within 1e-5 and the forecast within 1e-6 of the
    reference's (``tests/test_torch_macro_policy.py``'s A_t and forecast
    tolerances; both float32 networks)."""
    obs, hist = _inputs()
    np.testing.assert_allclose(
        p_pol.mean_action(pol_port, torch.from_numpy(obs), R)
        .detach().numpy(),
        np.asarray(r_pol.mean_action(pol_ref, jnp.asarray(obs), R)),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        p_pred.predict(pred_port, torch.from_numpy(hist)).detach().numpy(),
        np.asarray(r_pred.predict(pred_ref, jnp.asarray(hist))),
        atol=1e-6, rtol=0)


def test_reference_policy_checkpoint_drives_port(tmp_path):
    policy, pred = _ref_nets()
    ref_ckpt.save_checkpoint(str(tmp_path), 25,
                             {"policy": policy, "predictor": pred})
    step, tree = load_checkpoint(tmp_path, _template())
    assert step == 25
    pol_port = interop.policy_params_from_arrays(tree["policy"], R,
                                                 device="cpu")
    pred_port = interop.predictor_params_from_arrays(tree["predictor"], R,
                                                     device="cpu")
    np.testing.assert_array_equal(
        pol_port.policy.layers[-1].weight.detach().numpy(),
        np.asarray(policy["policy"][-1]["w"]).T)
    _outputs_close(pol_port, pred_port, policy, pred)


def test_port_policy_checkpoint_drives_reference(tmp_path):
    policy, pred = _ref_nets()
    pol_port = interop.policy_params_from_arrays(
        jax.tree.map(np.asarray, policy), R, device="cpu")
    pred_port = interop.predictor_params_from_arrays(
        jax.tree.map(np.asarray, pred), R, device="cpu")
    save_checkpoint(tmp_path, 3, {
        "policy": interop.policy_params_to_arrays(pol_port),
        "predictor": interop.predictor_params_to_arrays(pred_port)})
    fresh_pol, fresh_pred = _ref_nets()
    step, tree = ref_ckpt.load_checkpoint(
        str(tmp_path), {"policy": fresh_pol, "predictor": fresh_pred})
    assert step == 3
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            {"policy": policy, "predictor": pred})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _outputs_close(pol_port, pred_port, tree["policy"], tree["predictor"])


def test_inverse_bridges_round_trip_bitwise():
    pol, pred = _fresh_port_nets()
    back = interop.policy_params_from_arrays(
        interop.policy_params_to_arrays(pol), R, device="cpu")
    back_pred = interop.predictor_params_from_arrays(
        interop.predictor_params_to_arrays(pred), R, device="cpu")
    for a, b in zip(list(pol.parameters()) + list(pred.parameters()),
                    list(back.parameters()) + list(back_pred.parameters())):
        assert torch.equal(a, b)
    tree = interop.policy_params_to_arrays(pol)
    assert tree["policy"][0]["w"].shape == (obs_dim(R), p_pol.HIDDEN[0])


# ---------------------------------------------------- an LM checkpoint


def _zeros_like_descs(descs):
    if isinstance(descs, dict):
        return {k: _zeros_like_descs(v) for k, v in descs.items()}
    return torch.zeros(descs.shape)


def test_reference_lm_checkpoint_loads_in_port(tmp_path):
    """A reduced tinyllama's reference weights, saved as
    ``examples/train_lm.py`` saves them, give the port's model the
    reference's logits within ``tests/test_torch_models.py``'s 5e-4
    (1 + |want|)."""
    arch = "tinyllama-1.1b"
    ref = RefModel(ref_reduced(ref_get_config(arch)))
    params = ref.init(jax.random.PRNGKey(0))
    ref_ckpt.save_checkpoint(str(tmp_path), 20, {"params": params})
    cfg = reduced(get_config(arch))
    _, tree = load_checkpoint(tmp_path,
                              {"params": _zeros_like_descs(param_descs(cfg))})
    port = Model(cfg, device="cpu", params=interop.model_params_from_arrays(
        cfg, tree["params"], device="cpu"))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    toks = toks.astype(np.int32)
    want = ref.forward(params, jnp.asarray(toks))[0]
    got = port(torch.from_numpy(toks))[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-4, rtol=5e-4)
