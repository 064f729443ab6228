"""The port's learned macro layer (``core/{env,policy,ppo,predictor,
theory}.py``, ``optim/``) against the JAX package on the CPU, at the size
of ``tests/test_core_rl.py`` (R = 5, T = 24), with the same numpy-seeded
inputs and the same (bridged) weights on both sides.

Both sides compute in float32 with their own matrix products and
reductions, so deterministic pieces are held to tolerances set from
float32's rounding: the env and the optimizer step to 1e-6, the policy's
outputs and the plans to 1e-5, the PPO loss, its metrics and every
gradient to 1e-4 relative (the policy loss, a mean of normalised
advantages that sits at 0, to 1e-5 absolute), predictor training to
1e-4 relative over three epochs.  JAX and torch draw different random
numbers, so training curves are held to the reference tests' own
assertions, not to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import scipy.stats
import torch

from repro.core import env as r_env
from repro.core import policy as r_pol
from repro.core import ppo as r_ppo
from repro.core import predictor as r_pred
from repro.core import theory as r_theory
from repro.core.ot import exact_ot as r_exact_ot
from repro.core.ot import ot_cost as r_ot_cost
from repro.optim import adam as r_adam
from repro.optim import schedules as r_sched
from repro_torch import interop
from repro_torch.core import env as p_env
from repro_torch.core import policy as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.core import predictor as p_pred
from repro_torch.core import theory as p_theory
from repro_torch.core.ot import exact_ot, ot_cost
from repro_torch.optim import adam as p_adam
from repro_torch.optim import schedules as p_sched
from repro_torch.sim.metrics import prediction_accuracy

R, T = 5, 24


def _env_arrays(r=R, t=T, seed=0):
    """``tests/test_core_rl.py::_env``'s inputs."""
    rng = np.random.default_rng(seed)
    traffic = 40 + 25 * np.sin(np.linspace(0, 4 * np.pi, t))[:, None] \
        * rng.random((1, r)) + 5 * rng.random((t, r))
    traffic = np.maximum(traffic, 1.0)
    cap = rng.uniform(30, 90, r)
    power = rng.uniform(0.5, 2.0, r)
    lat = rng.uniform(5, 60, (r, r))
    np.fill_diagonal(lat, 1.0)
    return cap, power, lat, traffic


def _envs(seed=0):
    arrays = _env_arrays(seed=seed)
    return (r_env.make_env_params(*arrays),
            p_env.make_env_params(*arrays, device="cpu"))


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _ref_policy(seed=0):
    """The reference's initial policy, its numpy tree and the bridge."""
    params = r_pol.init_policy(jax.random.PRNGKey(seed), r_env.obs_dim(R), R)
    tree = jax.tree.map(np.asarray, params)
    return params, tree, interop.policy_params_from_arrays(tree, R,
                                                           device="cpu")


def _ref_batch(params, r_params, n_envs=4, n_steps=8):
    ro = r_ppo.collect_rollout(params, r_params, jax.random.PRNGKey(1),
                               n_envs, n_steps, R)
    n = n_envs * n_steps
    return ro, {
        "obs": ro.obs.reshape(n, -1), "p_star": ro.p_star.reshape(n, R, R),
        "raw": ro.raw.reshape(n, R, R), "log_probs": ro.log_probs.reshape(-1),
        "adv": ro.adv.reshape(-1), "returns": ro.returns.reshape(-1),
        "ot_dev": ro.ot_dev.reshape(-1), "switch": ro.switch.reshape(-1)}


def _grads_by_name(net, ref_grads):
    """The reference's gradient tree as the port's (name, array) pairs,
    ``w`` transposed into ``weight``."""
    out = {}
    for name, _ in net.named_parameters():
        part, _, i, kind = name.split(".")
        g = np.asarray(ref_grads[part][int(i)]["w" if kind == "weight"
                                                else "b"])
        out[name] = g.T if kind == "weight" else g
    return out


# ------------------------------------------------------------------ env


@pytest.mark.parametrize("seed", [0, 1])
def test_env_params_ot_probs_match_reference(seed):
    want, got = _envs(seed)
    np.testing.assert_allclose(_np(got.ot_probs), np.asarray(want.ot_probs),
                               atol=1e-5, rtol=0)
    for name in ("capacity", "power_cost", "latency", "traffic", "q_max",
                 "lambda1", "lambda2", "pred_noise", "w_net"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.horizon == want.horizon


@pytest.mark.parametrize("seed", [0, 1])
def test_env_obs_and_step_match_reference(seed):
    """Five steps under the same row-stochastic actions with pred_noise =
    0: each observation, reward, new state and info entry within 1e-6
    (absolute, or relative where the value exceeds 1)."""
    want_p, got_p = _envs(seed)
    rng = np.random.default_rng(seed + 10)
    s_ref = r_env.env_reset(want_p, jax.random.PRNGKey(seed))
    s_port = p_env.env_reset(got_p, torch.Generator().manual_seed(seed))
    for step in range(5):
        obs_ref = r_env.env_obs(want_p, s_ref)
        obs_port = p_env.env_obs(got_p, s_port)
        assert obs_port.shape == (1, p_env.obs_dim(R))
        np.testing.assert_allclose(_np(obs_port)[0], np.asarray(obs_ref),
                                   atol=1e-6, rtol=0, err_msg=f"obs {step}")
        a = rng.random((R, R)).astype(np.float32)
        a /= a.sum(1, keepdims=True)
        s_ref, rew_ref, info_ref = r_env.env_step(want_p, s_ref,
                                                  jnp.asarray(a))
        s_port, rew_port, info_port = p_env.env_step(
            got_p, s_port, torch.as_tensor(a)[None])
        np.testing.assert_allclose(_np(rew_port)[0], float(rew_ref),
                                   atol=1e-6, rtol=1e-6)
        for name in ("q", "u", "a_prev", "hist"):
            np.testing.assert_allclose(
                _np(getattr(s_port, name))[0], np.asarray(getattr(s_ref, name)),
                atol=1e-6, rtol=1e-6, err_msg=f"state.{name} {step}")
        assert int(s_port.t[0]) == int(s_ref.t)
        assert set(info_port) == set(info_ref)
        for name, v in info_ref.items():
            np.testing.assert_allclose(_np(info_port[name])[0], np.asarray(v),
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"info {name} {step}")


# --------------------------------------------------------------- policy


POLICY_FNS = {
    "beta_params": (lambda m, p, o: m.beta_params(p, o, R)),
    "value": (lambda m, p, o: m.value(p, o)),
    "mean_action": (lambda m, p, o: m.mean_action(p, o, R)),
    "beta_log_prob": (lambda m, p, o: m.beta_log_prob(
        *m.beta_params(p, o, R), _raw(o))),
    "beta_entropy": (lambda m, p, o: m.beta_entropy(*m.beta_params(p, o,
                                                                   R))),
}


def _raw(obs):
    x = np.random.default_rng(3).uniform(0.01, 0.99, (obs.shape[0], R, R))
    x = x.astype(np.float32)
    return torch.as_tensor(x) if isinstance(obs, torch.Tensor) \
        else jnp.asarray(x)


@pytest.mark.parametrize("fn", sorted(POLICY_FNS))
def test_policy_functions_match_reference_on_bridged_weights(fn):
    """The final policy layer scaled up 100x (undoing the init's 0.01) so
    the Betas are far from uniform."""
    params, tree, _ = _ref_policy()
    tree["policy"][-1]["w"] = tree["policy"][-1]["w"] * 100
    params = jax.tree.map(jnp.asarray, tree)
    net = interop.policy_params_from_arrays(tree, R, device="cpu")
    obs = np.random.default_rng(2).random((7, r_env.obs_dim(R)))
    obs = obs.astype(np.float32)
    want = POLICY_FNS[fn](r_pol, params, jnp.asarray(obs))
    got = POLICY_FNS[fn](p_pol, net, torch.as_tensor(obs))
    for w, g in zip(*((want, got) if fn == "beta_params"
                      else ((want,), (got,)))):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_betaln_and_beta_log_prob_match_scipy_up_to_1e3():
    """float32 alpha, beta in [1, 1e3]: betaln within 2 float32 ulps of
    scipy's (float64 on the float32 inputs); the log-density within 4
    ulps of the largest of its three terms."""
    a = np.geomspace(1.0, 1e3, 24, dtype=np.float32)
    alpha, beta = (m.ravel() for m in np.meshgrid(a, a[::-1]))
    x = np.random.default_rng(4).uniform(0.02, 0.98, alpha.shape)
    x = x.astype(np.float32)
    want_ln = scipy.special.betaln(alpha.astype(np.float64),
                                   beta.astype(np.float64))
    got_ln = _np(p_pol.betaln(torch.as_tensor(alpha), torch.as_tensor(beta)))
    ulp = np.finfo(np.float32).eps
    np.testing.assert_allclose(got_ln, want_ln, rtol=2 * ulp, atol=0)
    want = scipy.stats.beta.logpdf(x.astype(np.float64), alpha, beta)
    got = _np(p_pol.beta_log_prob(*(torch.as_tensor(v)
                                    for v in (alpha, beta, x))))
    scale = np.maximum.reduce([np.abs((alpha - 1.0) * np.log(x)),
                               np.abs((beta - 1.0) * np.log1p(-x)),
                               np.abs(want_ln)])
    assert np.all(np.abs(got - want) <= 4 * ulp * scale + 1e-6), \
        np.max(np.abs(got - want) / (scale + 1e-30))


def test_sample_action_valid_and_seeded():
    _, _, net = _ref_policy()
    obs = torch.zeros((3, p_env.obs_dim(R)))
    outs = [p_pol.sample_action(net, obs, torch.Generator().manual_seed(7), R)
            for _ in range(2)]
    a = outs[0]["action"]
    np.testing.assert_allclose(_np(a.sum(-1)), np.ones((3, R)), atol=1e-5)
    assert bool((a >= 0).all())
    assert np.isfinite(_np(outs[0]["log_prob"])).all()
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    m = p_pol.mean_action(net, obs, R)
    np.testing.assert_allclose(_np(m.sum(-1)), np.ones((3, R)), atol=1e-5)


# ------------------------------------------------------------------ PPO


def test_gae_matches_reference_rollout():
    """The reference rollout's rewards and values through the port's GAE
    and normalisation give its returns and advantages."""
    r_params, _ = _envs()
    params, _, _ = _ref_policy()
    ro, _ = _ref_batch(params, r_params)
    rewards, values = (torch.tensor(np.asarray(v))
                       for v in (ro.rewards, ro.values))
    adv = p_ppo.gae(rewards, values)
    np.testing.assert_allclose(_np(adv + values), np.asarray(ro.returns),
                               rtol=1e-6, atol=1e-6)
    norm = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    np.testing.assert_allclose(_np(norm), np.asarray(ro.adv), rtol=1e-5,
                               atol=1e-5)


def _loss_and_grads(gamma_c=0.7, delta_c=0.3):
    r_params, _ = _envs()
    params, _, net = _ref_policy()
    _, batch = _ref_batch(params, r_params)
    kw = dict(gamma_c=gamma_c, delta_c=delta_c, k0=0.4)
    (loss_r, met_r), grads_r = jax.value_and_grad(
        lambda p: r_ppo.ppo_loss(p, batch, R, **kw), has_aux=True)(params)
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    loss_p, met_p = p_ppo.ppo_loss(net, tb, R, **kw)
    grads_p = torch.autograd.grad(loss_p, list(net.parameters()))
    return (loss_r, met_r, grads_r), (loss_p, met_p, grads_p), net


def test_ppo_loss_and_metrics_match_reference():
    (loss_r, met_r, _), (loss_p, met_p, _), _ = _loss_and_grads()
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_r),
                               rtol=1e-4)
    assert set(met_p) == set(met_r)
    for k, v in met_r.items():
        atol = 1e-5 if k == "policy_loss" else 0.0
        np.testing.assert_allclose(_np(met_p[k]), float(v), rtol=1e-4,
                                   atol=atol, err_msg=k)


def test_ppo_gradients_match_reference():
    """Every gradient within 1e-4 of the reference's largest entry of the
    same parameter."""
    (_, _, grads_r), (_, _, grads_p), net = _loss_and_grads()
    want = _grads_by_name(net, grads_r)
    for (name, _), g in zip(net.named_parameters(), grads_p):
        w = want[name]
        assert g.shape == w.shape, name
        err = np.abs(_np(g) - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("clip,wd", [(None, 0.0), (1.0, 0.0), (1.0, 1e-2)])
def test_adam_update_matches_reference(clip, wd):
    """Two Adam steps with the reference's PPO gradients (global norm
    ~100, so the clip at 1.0 scales them): updates and moments within
    1e-6."""
    (_, _, grads_r), _, net = _loss_and_grads()
    params_r = r_pol.init_policy(jax.random.PRNGKey(0), r_env.obs_dim(R), R)
    ref_opt = r_adam.Adam(lr=3e-4, grad_clip=clip, weight_decay=wd)
    port_opt = p_adam.Adam(lr=3e-4, grad_clip=clip, weight_decay=wd)
    st_r = ref_opt.init(params_r)
    params_p = list(net.parameters())
    st_p = port_opt.init(params_p)
    g_p = [torch.tensor(g) for g in _grads_by_name(net, grads_r).values()]
    for step in range(2):
        upd_r, st_r = ref_opt.update(grads_r, st_r, params_r)
        params_r = r_adam.apply_updates(params_r, upd_r)
        upd_p, st_p = port_opt.update(g_p, st_p, params_p)
        p_adam.apply_updates(params_p, upd_p)
        for name, u in zip(dict(net.named_parameters()), upd_p):
            np.testing.assert_allclose(
                _np(u), _grads_by_name(net, upd_r)[name], rtol=1e-6,
                atol=1e-6 * 3e-4, err_msg=f"{name} step {step}")
    assert st_p.step == int(st_r.step) == 2
    want = _grads_by_name(net, params_r)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(_np(p), want[name], rtol=1e-6, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_update_matches_reference(momentum):
    """Two SGD steps with the reference's PPO gradients: updates within
    1e-6."""
    (_, _, grads_r), _, net = _loss_and_grads()
    params_r = r_pol.init_policy(jax.random.PRNGKey(0), r_env.obs_dim(R), R)
    ref_opt = r_adam.Sgd(lr=1e-2, momentum=momentum)
    port_opt = p_adam.Sgd(lr=1e-2, momentum=momentum)
    st_r, params_p = ref_opt.init(params_r), list(net.parameters())
    st_p = port_opt.init(params_p)
    g_p = [torch.tensor(g) for g in _grads_by_name(net, grads_r).values()]
    for step in range(2):
        upd_r, st_r = ref_opt.update(grads_r, st_r, params_r)
        upd_p, st_p = port_opt.update(g_p, st_p, params_p)
        want = _grads_by_name(net, upd_r)
        for name, u in zip(dict(net.named_parameters()), upd_p):
            np.testing.assert_allclose(_np(u), want[name], rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} {step}")


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("exponential_decay", (3e-4, 0.995, 100)),
    ("cosine_decay", (3e-4, 50)), ("warmup_cosine", (3e-4, 10, 50))])
def test_schedules_match_reference(name, args):
    ref, port = getattr(r_sched, name)(*args), getattr(p_sched, name)(*args)
    for step in (0, 1, 5, 10, 11, 37, 50, 80):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(port(step)), want, rtol=1e-6,
                                   err_msg=f"step {step}")


def test_ppo_update_runs_and_improves_smoothness():
    """``tests/test_core_rl.py``'s test on the port."""
    _, params_env = _envs()
    tr = p_ppo.PPOTrainer(params_env, R, n_envs=8, n_steps=T - 1, seed=0,
                          lr=1e-3, device="cpu")
    hist = tr.train(8)
    assert len(hist) == 8
    assert hist[-1]["ot_dev"] < hist[0]["ot_dev"] + 0.05
    assert np.isfinite(hist[-1]["reward"])


# ------------------------------------------------------------ predictor


def _predictor_data():
    """``tests/test_core_rl.py::test_predictor_learns_and_beats_ema``'s
    data."""
    rng = np.random.default_rng(0)
    t, r = 400, 6
    base = rng.random(r) + 0.2
    tt = np.arange(t)[:, None]
    arrivals = base[None, :] * (1.2 + np.sin(2 * np.pi * tt / 48
                                             + np.arange(r)[None, :]))
    arrivals = np.maximum(arrivals, 0.05) * 30
    util = np.clip(arrivals / arrivals.max(), 0, 1)
    queue = rng.random((t, r))
    return arrivals, util, queue


def test_make_dataset_bitwise():
    for got, want in zip(p_pred.make_dataset(*_predictor_data()),
                         r_pred.make_dataset(*_predictor_data())):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_predictor_fit_matches_reference_from_bridged_weights():
    """Three epochs from the same initial weights and minibatch order:
    every epoch's loss within 1e-4 relative, and the forecasts after."""
    hist, target = r_pred.make_dataset(*_predictor_data())
    ref = r_pred.PredictorTrainer(6, seed=0)
    port = p_pred.PredictorTrainer(6, seed=0, device="cpu")
    port.net.load_state_dict(interop.predictor_params_from_arrays(
        jax.tree.map(np.asarray, ref.params), 6, device="cpu").state_dict())
    np.testing.assert_allclose(port(hist[:9]), ref(hist[:9]), rtol=1e-5,
                               atol=1e-6)
    want = ref.fit(hist, target, epochs=3)
    got = port.fit(hist, target, epochs=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(port(hist[:9]), ref(hist[:9]), rtol=1e-3,
                               atol=1e-4)


def test_predictor_learns_and_beats_ema():
    """``tests/test_core_rl.py``'s test on the port."""
    arrivals, util, queue = _predictor_data()
    hist, target = p_pred.make_dataset(arrivals, util, queue)
    n_train = int(0.8 * len(hist))
    trainer = p_pred.PredictorTrainer(6, seed=0, device="cpu")
    trainer.fit(hist[:n_train], target[:n_train], epochs=40)
    pred = trainer(hist[n_train:])
    ema = p_pred.EmaPredictor(6, alpha=0.5)
    ema_preds = []
    for i in range(n_train, n_train + len(pred)):
        ema.update(arrivals[i])
        ema_preds.append(ema.predict())
    pa_nn = prediction_accuracy(pred, target[n_train:])
    pa_ema = prediction_accuracy(np.array(ema_preds), target[n_train:])
    assert pa_nn > 0.5, f"NN predictor accuracy too low: {pa_nn}"
    assert pa_nn >= pa_ema - 0.02, (pa_nn, pa_ema)


# ------------------------------------------------------- OT and theory


def test_exact_ot_and_ot_cost_match_reference():
    """The LP plan equal (the same HiGHS problem); the plan's cost within
    2 float32 ulps."""
    rng = np.random.default_rng(8)
    mu, nu = rng.random(R) + 0.1, rng.random(R) + 0.1
    mu, nu = mu / mu.sum(), nu / nu.sum()
    cost = rng.random((R, R))
    plan = exact_ot(mu, nu, cost)
    np.testing.assert_array_equal(plan, r_exact_ot(mu, nu, cost))
    c32 = cost.astype(np.float32)
    plans = np.stack([plan, plan.T]).astype(np.float32)
    # a float32 sum of R^2 products: the two sides' summation orders
    np.testing.assert_allclose(
        _np(ot_cost(torch.as_tensor(plans), torch.as_tensor(c32))),
        np.asarray(r_ot_cost(jnp.asarray(plans), jnp.asarray(c32))),
        rtol=2 * np.finfo(np.float32).eps, atol=0)


def test_theory_matches_reference():
    """K0 from the reactive plans within 1e-5 relative (float32 plans from
    two Sinkhorns); the host-numpy pieces equal."""
    cap, power, lat, traffic = _env_arrays()
    want = r_theory.estimate_k0_from_reactive(R, traffic, cap, power, lat)
    got = p_theory.estimate_k0_from_reactive(R, traffic, cap, power, lat,
                                             device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    sw = np.random.default_rng(9).random(30)
    assert p_theory.estimate_k0(sw) == r_theory.estimate_k0(sw)

    def cost_fn(a):
        return float(np.sum(a * lat) + 0.3 * np.sum(a ** 2))
    a0 = np.full((R, R), 1.0 / R)
    assert p_theory.estimate_lipschitz(cost_fn, a0) == \
        r_theory.estimate_lipschitz(cost_fn, a0)
    ref = r_theory.AdvantageCondition(k0=want, l_r=0.8, l_p=0.5, beta=0.7)
    port = p_theory.AdvantageCondition(k0=want, l_r=0.8, l_p=0.5, beta=0.7)
    for eps, s in ((0.01, 1.5), (0.2, 3.0), (0.5, 0.9), (0.0, 2.0)):
        assert port.holds(eps, s) == ref.holds(eps, s)
        assert port.min_s(eps) == ref.min_s(eps)
        assert port.max_eps(s) == ref.max_eps(s)
    assert port.upper_bound_cost(1.3, 40) == ref.upper_bound_cost(1.3, 40)


# --------------------------------------------------------------- interop


@pytest.mark.parametrize("fault", ["missing key", "wrong shape",
                                   "missing layer"])
def test_bridges_raise_on_a_bad_tree(fault):
    _, tree, _ = _ref_policy()
    pred_tree = jax.tree.map(np.asarray, r_pred.init_predictor(
        jax.random.PRNGKey(0), R))
    if fault == "missing key":
        del tree["policy"][1]["b"]
        del pred_tree[0]["w"]
    elif fault == "wrong shape":
        tree["value"][0]["w"] = tree["value"][0]["w"][:-1]
        pred_tree[2]["b"] = pred_tree[2]["b"][:-1]
    else:
        tree["value"] = tree["value"][:-1]
        pred_tree = pred_tree[:-1]
    with pytest.raises(ValueError, match="parameter"):
        interop.policy_params_from_arrays(tree, R, device="cpu")
    with pytest.raises(ValueError, match="parameter"):
        interop.predictor_params_from_arrays(pred_tree, R, device="cpu")
