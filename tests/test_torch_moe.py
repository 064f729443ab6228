"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``)
against the JAX package's (``repro/models/moe.py``) on the same
numpy-seeded inputs: the routing (expert ids, weights, the balance loss)
and ``moe_ffn_local``'s output, with and without dropped picks, for the
three MoE configs' expert counts and picks a token.  Expert ids and
which picks are dropped must be identical; the output and the aux are
held within 5e-4 relative to their size (float32 products summed in
another order), values that are exact within 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import MoEConfig as RefMoEConfig
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Model as RefModel
from repro.models import moe as ref_moe
from repro_torch.configs import MoEConfig, get_config, reduced
from repro_torch.interop import model_params_from_arrays
from repro_torch.models import moe

TOL = 5e-4
EXACT = 1e-6
# (experts, picks a token): mixtral, qwen3-moe, jamba
EXPERTS = {"mixtral": (8, 2), "qwen3-moe": (128, 8), "jamba": (16, 2)}


def _configs(e, k, f):
    return RefMoEConfig(e, k, f), MoEConfig(e, k, f)


def _params(rng, e, d, f, bias=0.0):
    """Expert weights and a router, as numpy; ``bias`` on the router's
    weight from feature 0 (1 in every token of :func:`_tokens`) to expert
    0 makes that expert overflow its capacity."""
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "w_gate": (rng.standard_normal((e, d, f)) * 0.3).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, f)) * 0.3).astype(np.float32),
         "w_down": (rng.standard_normal((e, f, d)) * 0.3).astype(np.float32)}
    p["router"][0, 0] += bias
    return p


def _tokens(rng, t, d):
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[:, 0] = 1.0
    return x


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def _kept_picks(experts, c, offset=0, local=None):
    """The dispatch rule written out pick by pick: picks in token-major
    order, an expert's first ``c`` kept (if it is local).  Returns the
    kept (token, slot) pairs."""
    local = experts.max() + 1 if local is None else local
    seen = {}
    kept = set()
    for t, row in enumerate(np.asarray(experts)):
        for j, ex in enumerate(row):
            rank = seen.get(int(ex), 0)
            seen[int(ex)] = rank + 1
            if offset <= ex < offset + local and rank < c:
                kept.add((t, j))
    return kept


def _port_kept(experts, c, offset=0, local=None):
    """The (token, slot) pairs the port's dispatch keeps."""
    k = experts.shape[1]
    local = int(experts.max()) + 1 if local is None else local
    order, _, keep = moe.dispatch(experts, c, expert_offset=offset,
                                  local_experts=local)
    flat = order[keep].numpy()
    return {(int(i) // k, int(i) % k) for i in flat}


def test_full_routing_equals_dense():
    """top_k == num_experts with a zero (uniform) router: the average of
    every expert, balance loss 1 (``tests/test_layers.py``'s case)."""
    rng = np.random.default_rng(0)
    t, d, f, e = 6, 8, 16, 2
    ref_m, m = _configs(e, e, f)
    p = {"router": np.zeros((d, e), np.float32),
         "w_gate": (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
         "w_up": (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
         "w_down": (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((t, d)).astype(np.float32)
    want, want_aux = ref_moe.moe_ffn_local(_jax(p), jnp.asarray(x), ref_m,
                                           jax.nn.silu)
    got, aux = moe.moe_ffn_local(_torch(p), torch.from_numpy(x), m, F.silu)
    dense = sum(0.5 * (F.silu(torch.from_numpy(x) @ _torch(p)["w_gate"][i])
                       * (torch.from_numpy(x) @ _torch(p)["w_up"][i]))
                @ _torch(p)["w_down"][i] for i in range(e))
    _close(got, want, "y vs the reference")
    _close(got, dense, "y vs the dense average", 1e-5)
    _close(aux, want_aux, "aux", EXACT)
    assert float(aux) == pytest.approx(1.0, rel=1e-3)


def test_capacity_one_drops():
    """Capacity 1, every token to expert 0: only the first token is
    computed, as in the reference."""
    t, d, f = 5, 4, 8
    ref_m, m = _configs(2, 1, f)
    router = np.zeros((d, 2), np.float32)
    router[:, 0] = 10.0
    p = {"router": router, "w_gate": np.full((2, d, f), 0.1, np.float32),
         "w_up": np.full((2, d, f), 0.1, np.float32),
         "w_down": np.full((2, f, d), 0.1, np.float32)}
    x = np.ones((t, d), np.float32)
    want, _ = ref_moe.moe_ffn_local(_jax(p), jnp.asarray(x), ref_m,
                                    jax.nn.silu, capacity=1)
    got, _ = moe.moe_ffn_local(_torch(p), torch.from_numpy(x), m, F.silu,
                               capacity=1)
    _close(got, want, "y")
    assert int((got.abs().sum(-1) > 1e-9).sum()) == 1
    assert float(got[1:].abs().max()) == 0.0


@pytest.mark.parametrize("name", sorted(EXPERTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_routing_matches_reference(name, seed):
    """Random router and tokens: the same expert ids, weights and aux."""
    e, k = EXPERTS[name]
    rng = np.random.default_rng(seed)
    d = 32
    ref_m, m = _configs(e, k, 16)
    router = rng.standard_normal((d, e)).astype(np.float32)
    x = rng.standard_normal((50, d)).astype(np.float32)
    w_ref, i_ref, a_ref = ref_moe._routing(jnp.asarray(router),
                                           jnp.asarray(x), ref_m)
    w, i, a = moe._routing(torch.from_numpy(router), torch.from_numpy(x), m)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(w, w_ref, "weights", EXACT)
    _close(a, a_ref, "aux", EXACT)


@pytest.mark.parametrize("name", sorted(EXPERTS))
def test_zero_router_picks_the_lowest_ids(name):
    """A zero router gives every expert the same probability; ``lax.top_k``
    then returns experts 0..k-1 for every token, and so must the port."""
    e, k = EXPERTS[name]
    ref_m, m = _configs(e, k, 16)
    x = np.random.default_rng(3).standard_normal((9, 16)).astype(np.float32)
    router = np.zeros((16, e), np.float32)
    w_ref, i_ref, a_ref = ref_moe._routing(jnp.asarray(router),
                                           jnp.asarray(x), ref_m)
    w, i, a = moe._routing(torch.from_numpy(router), torch.from_numpy(x), m)
    np.testing.assert_array_equal(np.asarray(i_ref),
                                  np.tile(np.arange(k), (9, 1)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    _close(w, np.full((9, k), 1.0 / k), "weights", EXACT)
    _close(a, a_ref, "aux", EXACT)


@pytest.mark.parametrize("name", sorted(EXPERTS))
@pytest.mark.parametrize("tokens", [20, 300])
def test_ffn_matches_reference(name, tokens):
    """``moe_ffn_local`` on a random router: 20 tokens (no drops), and
    300 tokens with expert 0 favoured (more than 512 picks for every
    config: a computed capacity that some expert overflows)."""
    e, k = EXPERTS[name]
    rng = np.random.default_rng(4)
    d, f = 16, 24
    ref_m, m = _configs(e, k, f)
    p = _params(rng, e, d, f, bias=2.0 if tokens > 20 else 0.0)
    x = _tokens(rng, tokens, d)
    want, want_aux = ref_moe.moe_ffn_local(_jax(p), jnp.asarray(x), ref_m,
                                           jax.nn.silu)
    got, aux = moe.moe_ffn_local(_torch(p), torch.from_numpy(x), m, F.silu)
    _close(got, want, "y")
    _close(aux, want_aux, "aux", EXACT)
    _, experts, _ = moe._routing(torch.from_numpy(p["router"]),
                                 torch.from_numpy(x), m)
    c = moe.capacity_of(tokens * k, m)
    kept = _port_kept(experts, c, local=e)
    assert kept == _kept_picks(experts.numpy(), c)
    dropped = tokens * k - len(kept)
    if tokens * k > 512:
        assert c == max(8, int(tokens * k / e * 1.25)) < tokens * k
        assert dropped > 0
    else:
        assert c == tokens * k and dropped == 0


def test_overflowing_expert_drops_the_reference_picks():
    """tk > 512 with one expert over its computed capacity: the port keeps
    exactly the picks the reference's rule keeps (the dispatch oracle, on
    the reference's own expert ids), and a token with a dropped pick
    gets exactly the reference's output."""
    rng = np.random.default_rng(5)
    e, k, t, d, f = 4, 2, 400, 8, 16
    ref_m, m = _configs(e, k, f)
    p = _params(rng, e, d, f, bias=3.0)
    x = _tokens(rng, t, d)
    _, i_ref, _ = ref_moe._routing(jnp.asarray(p["router"]), jnp.asarray(x),
                                   ref_m)
    c = moe.capacity_of(t * k, m)
    assert c == 250
    want_kept = _kept_picks(np.asarray(i_ref), c)
    got_kept = _port_kept(torch.from_numpy(np.asarray(i_ref, np.int64)), c,
                          local=e)
    assert got_kept == want_kept
    assert len(want_kept) < t * k
    want, _ = ref_moe.moe_ffn_local(_jax(p), jnp.asarray(x), ref_m,
                                    jax.nn.silu)
    got, _ = moe.moe_ffn_local(_torch(p), torch.from_numpy(x), m, F.silu)
    short = sorted({tok for tok in range(t) for j in range(k)
                    if (tok, j) not in want_kept})
    _close(got[short], np.asarray(want)[short], "rows with a dropped pick")


@pytest.mark.parametrize("tokens", [12, 300])
def test_expert_halves_sum_to_the_whole(tokens):
    """Two ranks' shares (``expert_offset`` / ``local_experts``, each with
    its own experts' weights) sum to the whole layer, and each share
    equals the reference's."""
    rng = np.random.default_rng(6)
    e, k, d, f = 8, 2, 16, 24
    ref_m, m = _configs(e, k, f)
    p = _params(rng, e, d, f, bias=1.0)
    x = _tokens(rng, tokens, d)
    whole, aux = moe.moe_ffn_local(_torch(p), torch.from_numpy(x), m, F.silu)
    parts = []
    for off in (0, e // 2):
        share = dict(p, **{w: p[w][off:off + e // 2]
                           for w in ("w_gate", "w_up", "w_down")})
        got, got_aux = moe.moe_ffn_local(_torch(share), torch.from_numpy(x),
                                         m, F.silu, expert_offset=off,
                                         local_experts=e // 2)
        want, _ = ref_moe.moe_ffn_local(_jax(share), jnp.asarray(x), ref_m,
                                        jax.nn.silu, expert_offset=off,
                                        local_experts=e // 2)
        _close(got, want, f"share at offset {off}")
        assert float(got_aux) == float(aux)
        parts.append(got)
    _close(parts[0] + parts[1], whole, "the shares' sum", 1e-5)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b"])
def test_bridge_carries_the_expert_tensors(arch):
    """``model_params_from_arrays`` on a JAX MoE model's tree: the stacked
    (groups, E, D, F) expert tensors and the router arrive unchanged; a
    wrong expert count is refused."""
    ref_cfg = ref_reduced(ref_get_config(arch))
    cfg = reduced(get_config(arch))
    tree = jax.tree.map(np.asarray, RefModel(ref_cfg).init(
        jax.random.PRNGKey(0)))
    got = model_params_from_arrays(cfg, tree, device="cpu")
    pos = "pos0" if cfg.layer_uses_moe(0) else "pos1"
    ffn, want = got["groups"][pos]["ffn"], tree["groups"][pos]["ffn"]
    g = cfg.num_layers // len(cfg.layer_period)
    m = cfg.moe
    assert tuple(ffn["w_gate"].shape) == (g, m.num_experts, cfg.d_model,
                                          m.d_ff_expert)
    assert tuple(ffn["w_down"].shape) == (g, m.num_experts, m.d_ff_expert,
                                          cfg.d_model)
    for key in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(ffn[key].numpy(), want[key])
    tree["groups"][pos]["ffn"]["w_up"] = want["w_up"][:, :-1]
    with pytest.raises(ValueError, match="w_up"):
        model_params_from_arrays(cfg, tree, device="cpu")


def test_configs_capacity_at_a_served_admit():
    """The capacities of a 512-token admit at the published configs, and
    none at a batch-4 decode tick."""
    want = {"mixtral-8x7b": (1024, 160), "qwen3-moe-235b-a22b": (4096, 40),
            "jamba-v0.1-52b": (1024, 80)}
    for arch, (tk, c) in want.items():
        m = get_config(arch).moe
        assert 512 * m.top_k == tk
        assert moe.capacity_of(tk, m) == c
        assert moe.capacity_of(4 * m.top_k, m) == 4 * m.top_k
        assert dataclasses.asdict(m) == dataclasses.asdict(
            ref_get_config(arch).moe)
