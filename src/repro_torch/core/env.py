"""Macro-level environment for PPO training (§V-B2 MDP), port of
``repro/core/env.py``, batched over envs on a leading dim (the reference
vmaps one env).

State s_t = (U_t, Q_t, L, H_t, F_t, A_{t-1}); dynamics evolve region-level
queues under the allocation action:

    flows_ij = arrivals_i * A_ij
    Q'_j     = Q_j + sum_i flows_ij - served_j,  served = min(Q+in, cap)

Reward (Eq 3): r_OT + l1 * r_smooth + l2 * r_cost, with P*_t precomputed
for every slot of the training traffic as one batch through the Sinkhorn
kernel's wrapper.  The demand feature F_t is the true next-slot arrival
distribution mixed with Dirichlet noise (``pred_noise``; at 0 it is the
true distribution exactly).  Everything stays on ``device``: a step reads
nothing back to the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.ot import slot_routing_probs
from repro_torch.core.predictor import K_HIST


class EnvParams(NamedTuple):
    capacity: torch.Tensor    # (R,) tasks per slot
    power_cost: torch.Tensor  # (R,) $ per served task
    latency: torch.Tensor     # (R, R) ms
    traffic: torch.Tensor     # (T, R) arrivals per slot
    ot_probs: torch.Tensor    # (T, R, R) Sinkhorn routing probs per slot
    q_max: torch.Tensor       # scalars: 0-d float32, as the reference's
    lambda1: torch.Tensor     # smoothness weight (Eq 3)
    lambda2: torch.Tensor     # cost weight (Eq 3)
    pred_noise: torch.Tensor  # 0 = oracle forecast, 1 = uninformative
    w_net: torch.Tensor       # power-cost network weight
    horizon: int


class EnvState(NamedTuple):
    q: torch.Tensor           # (E, R)
    u: torch.Tensor           # (E, R)
    a_prev: torch.Tensor      # (E, R, R)
    hist: torch.Tensor        # (E, K, R) recent arrival distributions
    t: torch.Tensor           # (E,) int64
    gen: torch.Generator      # the forecast noise's draws


def make_env_params(capacity: np.ndarray, power_cost: np.ndarray,
                    latency: np.ndarray, traffic: np.ndarray, *,
                    lambda1: float = 0.5, lambda2: float = 0.5,
                    pred_noise: float = 0.0, w_net: float = 0.01,
                    reg: float = 0.05, device="cuda") -> EnvParams:
    """The env's tensors on ``device``, with the OT plan of every slot of
    ``traffic`` from one (T, R) launch of the Sinkhorn kernel."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return EnvParams(
        capacity=f32(capacity), power_cost=f32(power_cost),
        latency=f32(latency), traffic=f32(traffic),
        ot_probs=slot_routing_probs(traffic, capacity, power_cost, latency,
                                    reg=reg, device=dev),
        q_max=f32(10.0 * float(capacity.sum())),
        lambda1=f32(lambda1), lambda2=f32(lambda2),
        pred_noise=f32(pred_noise), w_net=f32(w_net),
        horizon=int(traffic.shape[0]))


def env_reset(params: EnvParams, gen: torch.Generator, n_envs: int = 1
              ) -> EnvState:
    r, dev = params.capacity.shape[0], params.capacity.device
    return EnvState(
        q=torch.zeros((n_envs, r), device=dev),
        u=torch.zeros((n_envs, r), device=dev),
        a_prev=torch.full((n_envs, r, r), 1.0 / r, device=dev),
        hist=torch.full((n_envs, K_HIST, r), 1.0 / r, device=dev),
        t=torch.zeros((n_envs,), dtype=torch.int64, device=dev),
        gen=gen)


def obs_dim(n_regions: int) -> int:
    r = n_regions
    return r + r + r * r + K_HIST * r + r + r * r


def env_obs(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(E, obs_dim) observations."""
    e = state.q.shape[0]
    nxt = params.traffic[torch.clamp(state.t + 1, max=params.horizon - 1)]
    f_true = nxt / torch.clamp(nxt.sum(-1, keepdim=True), min=1e-9)
    noise = torch._sample_dirichlet(torch.ones_like(f_true),
                                    generator=state.gen)
    f = (1 - params.pred_noise) * f_true + params.pred_noise * noise
    lat = params.latency / torch.clamp(params.latency.max(), min=1e-9)
    return torch.cat([
        state.u,
        state.q / params.q_max,
        lat.reshape(1, -1).expand(e, -1),
        state.hist.reshape(e, -1),
        f,
        state.a_prev.reshape(e, -1),
    ], dim=-1)


def env_step(params: EnvParams, state: EnvState, action: torch.Tensor
             ) -> Tuple[EnvState, torch.Tensor, Dict[str, torch.Tensor]]:
    """action: (E, R, R) -> new state, (E,) rewards, (E, ...) infos."""
    # past the horizon the reference's gather clamps; so does this one
    t = torch.clamp(state.t, max=params.horizon - 1)
    arrivals = params.traffic[t]                         # (E, R)
    flows = arrivals[:, :, None] * action                # i -> j
    incoming = flows.sum(1)
    q_tot = state.q + incoming
    served = torch.minimum(q_tot, params.capacity)
    q_new = q_tot - served
    util = served / torch.clamp(params.capacity, min=1e-9)

    p_star = params.ot_probs[t]
    r_ot = -torch.sum(torch.square(action - p_star), dim=(-2, -1))
    switch = torch.sum(torch.square(action - state.a_prev), dim=(-2, -1))
    r_smooth = -switch
    r_cost = -torch.sum(q_new, dim=-1) / params.q_max
    reward = r_ot + params.lambda1 * r_smooth + params.lambda2 * r_cost

    power = torch.sum(served * params.power_cost, dim=-1) + \
        params.w_net * torch.sum(flows * params.latency, dim=(-2, -1))
    arr_dist = arrivals / torch.clamp(arrivals.sum(-1, keepdim=True),
                                      min=1e-9)
    hist = torch.cat([state.hist[:, 1:], arr_dist[:, None]], dim=1)
    new_state = EnvState(q=q_new, u=util, a_prev=action, hist=hist,
                         t=state.t + 1, gen=state.gen)
    info = {
        "p_star": p_star,
        "queue": torch.sum(q_new, dim=-1),
        "power": power,
        "switch": switch,
        "ot_dev": torch.sqrt(-r_ot),
        "util_cv": torch.std(util, dim=-1, correction=0)
        / torch.clamp(torch.mean(util, dim=-1), min=1e-9),
        "dropped": torch.clamp(torch.sum(q_new, dim=-1) - params.q_max,
                               min=0.0),
        "r_ot": r_ot, "r_smooth": r_smooth, "r_cost": r_cost,
    }
    return new_state, reward, info
