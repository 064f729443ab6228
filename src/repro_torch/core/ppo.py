"""PPO with OT supervision and the paper's constrained training objective
(port of ``repro/core/ppo.py``).

    L_total = L_PPO + gamma * L_eps + delta * L_s          (Eq 5)

    L_eps = max(0, (||A_RL - A_OT||_F - eps_max) / eps0)   — OT deviation
    L_s   = max(0, (s_min - s_current) / s0)               — switching gain

gamma/delta are adapted between iterations per Appendix B:
    gamma = gamma0 * exp(a_g * max(0, ||B||_F - eps_target))
    delta = delta0 * exp(a_d * max(0, s_target - s_current))

The trainer validates the Thm-3 advantage condition
    (1 - 1/s) / eps > (L_R + beta * L_P) / (alpha * K0)
every iteration.  The rollout is a Python loop over the steps with the envs
batched, on ``device`` until its last read (the reference's one jitted
scan); gradients come from ``torch.autograd``; the constraint weights and
the Thm-3 check are host floats, read once an iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import policy as pol
from repro_torch.core.env import (EnvParams, env_obs, env_reset, env_step,
                                  obs_dim)
from repro_torch.optim.adam import Adam, apply_updates


class Rollout(NamedTuple):
    obs: torch.Tensor        # (E, T, obs)
    p_star: torch.Tensor     # (E, T, R, R) OT supervision targets
    raw: torch.Tensor        # (E, T, R, R) raw beta samples
    actions: torch.Tensor    # (E, T, R, R)
    log_probs: torch.Tensor  # (E, T)
    values: torch.Tensor     # (E, T)
    rewards: torch.Tensor    # (E, T)
    ot_dev: torch.Tensor     # (E, T) ||A - P*||_F
    switch: torch.Tensor     # (E, T) ||A_t - A_{t-1}||_F^2
    adv: torch.Tensor        # (E, T)
    returns: torch.Tensor    # (E, T)


def gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float = 0.99,
        lam: float = 0.95) -> torch.Tensor:
    """(E, T) generalized advantage estimates, the last step bootstrapped
    from 0 (the reference's reversed scan)."""
    adv_next = torch.zeros_like(rewards[:, 0])
    v_next = torch.zeros_like(values[:, 0])
    advs = []
    for t in range(rewards.shape[1] - 1, -1, -1):
        delta = rewards[:, t] + gamma * v_next - values[:, t]
        adv_next = delta + gamma * lam * adv_next
        v_next = values[:, t]
        advs.append(adv_next)
    return torch.stack(advs[::-1], dim=1)


@torch.no_grad()
def collect_rollout(net: pol.PolicyNet, env_params: EnvParams,
                    gen: torch.Generator, n_envs: int, n_steps: int,
                    n_regions: int, gamma: float = 0.99, lam: float = 0.95
                    ) -> Rollout:
    """``n_steps`` steps of ``n_envs`` envs under the sampled policy; the
    forecast noise and the actions draw from ``gen``."""
    state = env_reset(env_params, gen, n_envs)
    recs = []
    for _ in range(n_steps):
        obs = env_obs(env_params, state)
        out = pol.sample_action(net, obs, gen, n_regions)
        state, rewards, infos = env_step(env_params, state, out["action"])
        recs.append((obs, infos["p_star"], out["raw"], out["action"],
                     out["log_prob"], out["value"], rewards,
                     infos["ot_dev"], infos["switch"]))
    (obs, p_star, raw, actions, log_probs, values, rewards, ot_dev,
     switch) = [torch.stack(r, dim=1) for r in zip(*recs)]  # (E, T, ...)
    adv = gae(rewards, values, gamma, lam)
    returns = adv + values
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return Rollout(obs, p_star, raw, actions, log_probs, values, rewards,
                   ot_dev, switch, adv, returns)


def flatten(ro: Rollout) -> Dict[str, torch.Tensor]:
    """The rollout's fields ``ppo_loss`` reads, envs and steps merged
    into one leading dim."""
    e, t = ro.rewards.shape
    return {"obs": ro.obs.reshape(e * t, -1),
            "p_star": ro.p_star.flatten(0, 1), "raw": ro.raw.flatten(0, 1),
            **{k: getattr(ro, k).reshape(-1)
               for k in ("log_probs", "adv", "returns", "ot_dev", "switch")}}


def ppo_loss(net: pol.PolicyNet, batch: Dict[str, torch.Tensor],
             n_regions: int, *, clip_eps: float = 0.2, vf_coef: float = 0.5,
             ent_coef: float = 1e-3, gamma_c: float = 0.0,
             delta_c: float = 0.0, eps_max: float = 0.15, eps0: float = 0.05,
             s_min: float = 2.5, s0: float = 0.5, k0: float = 1.0,
             sup_coef: float = 2.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    alpha, beta = pol.beta_params(net, batch["obs"], n_regions)
    lp = pol.beta_log_prob(alpha, beta, batch["raw"]).sum((-2, -1))
    ratio = torch.exp(lp - batch["log_probs"])
    adv = batch["adv"]
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv)
    policy_loss = -surr.mean()
    v = pol.value(net, batch["obs"])
    value_loss = torch.mean(torch.square(v - batch["returns"]))
    entropy = pol.beta_entropy(alpha, beta).sum((-2, -1)).mean()

    # OT plans as supervised signals (paper abstract / §V-B2): pull the
    # policy mean toward P*_t directly, on top of the r_OT reward channel
    mean = alpha / (alpha + beta)
    mean = mean / mean.sum(-1, keepdim=True)
    sup = torch.mean(torch.sum(torch.square(mean - batch["p_star"]),
                               dim=(-2, -1)))

    # constraint terms (Eq 5 / Appendix A Definition 2)
    l_eps = torch.clamp((batch["ot_dev"].mean() - eps_max) / eps0, min=0.0)
    s_current = k0 / torch.clamp(batch["switch"].mean(), min=1e-6)
    l_s = torch.clamp((s_min - s_current) / s0, min=0.0)

    total = (policy_loss + vf_coef * value_loss - ent_coef * entropy
             + sup_coef * sup + gamma_c * l_eps + delta_c * l_s)
    metrics = {"policy_loss": policy_loss, "value_loss": value_loss,
               "entropy": entropy, "l_eps": l_eps, "l_s": l_s, "sup": sup,
               "s_current": s_current, "ratio": ratio.mean()}
    return total, metrics


@dataclasses.dataclass
class PPOTrainer:
    env_params: EnvParams
    n_regions: int
    n_envs: int = 16
    n_steps: int = 64
    lr: float = 3e-4
    lr_decay: float = 0.995     # every 100 episodes (Appendix B)
    epochs: int = 4
    minibatches: int = 8
    seed: int = 0
    # constrained-objective targets (Algorithm 2 line 5)
    eps_target: float = 0.15
    s_target: float = 2.5
    gamma0: float = 0.5
    delta0: float = 0.5
    k0: float = 1.0              # baseline switching cost (theory.estimate_k0)
    alpha_weight: float = 1.0    # objective weights (Eq 1)
    beta_weight: float = 1.0
    lipschitz: Tuple[float, float] = (1.0, 1.0)   # (L_R, L_P)
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.net = pol.init_policy(
            torch.Generator(device=self.device).manual_seed(self.seed),
            obs_dim(self.n_regions), self.n_regions)
        self.opt = Adam(lr=self.lr, grad_clip=1.0)
        self.opt_state = self.opt.init(list(self.net.parameters()))
        self.gamma_c = self.gamma0
        self.delta_c = self.delta0
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 1)
        self.history: List[Dict[str, float]] = []

    def update(self, batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One Adam step of the Eq-5 loss on a minibatch."""
        params = list(self.net.parameters())
        loss, metrics = ppo_loss(
            self.net, batch, self.n_regions, gamma_c=self.gamma_c,
            delta_c=self.delta_c, eps_max=self.eps_target,
            s_min=self.s_target, k0=self.k0)
        grads = torch.autograd.grad(loss, params)
        updates, self.opt_state = self.opt.update(grads, self.opt_state,
                                                  params)
        apply_updates(params, updates)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def rollout(self) -> Rollout:
        return collect_rollout(self.net, self.env_params, self._gen,
                               self.n_envs, self.n_steps, self.n_regions)

    def train(self, iterations: int = 20, verbose: bool = False
              ) -> List[Dict[str, float]]:
        for it in range(iterations):
            self.train_on(self.rollout(), it)
            if verbose:
                print(self.history[-1])
        return self.history

    def train_on(self, ro: Rollout, it: int) -> Dict[str, float]:
        """Iteration ``it`` of Algorithm 2 on a rollout: ``epochs`` passes
        over ``minibatches`` minibatches in the order of
        ``np.random.default_rng(seed + it)``, then the adaptive constraint
        weights and the Thm-3 check."""
        flat = flatten(ro)
        n = self.n_envs * self.n_steps
        mb = n // self.minibatches
        perm = torch.as_tensor(np.random.default_rng(self.seed + it)
                               .permutation(n), device=self.device)
        metrics = {}
        for _ in range(self.epochs):
            for i in range(self.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                _, metrics = self.update({k: v[idx]
                                          for k, v in flat.items()})
        # adaptive constraint weights (Appendix B)
        b_norm = float(ro.ot_dev.mean())
        switch = float(ro.switch.mean())
        s_cur = float(self.k0 / max(switch, 1e-6))
        self.gamma_c = float(self.gamma0 *
                             np.exp(2.0 * max(0.0, b_norm - self.eps_target)))
        self.delta_c = float(self.delta0 *
                             np.exp(2.0 * max(0.0, self.s_target - s_cur)))
        cond = self.advantage_condition(b_norm, s_cur)
        if cond is not None and not cond:
            self.gamma_c *= 1.5
            self.delta_c *= 1.5
        rec = {"iter": it, "reward": float(ro.rewards.mean()),
               "ot_dev": b_norm, "s_current": s_cur, "switch": switch,
               "gamma_c": self.gamma_c, "delta_c": self.delta_c,
               "advantage_condition": bool(cond) if cond is not None else None,
               **{k: float(v) for k, v in metrics.items()}}
        self.history.append(rec)
        return rec

    def advantage_condition(self, eps: float, s: float) -> Optional[bool]:
        """Thm 3: (1 - 1/s)/eps > (L_R + beta*L_P) / (alpha*K0)."""
        if s <= 1 or eps <= 0:
            return False
        lr_, lp_ = self.lipschitz
        lhs = (1 - 1 / s) / eps
        rhs = (lr_ + self.beta_weight * lp_) / (self.alpha_weight * self.k0)
        return lhs > rhs

    def act(self, obs: np.ndarray) -> np.ndarray:
        """The policy's mean action for ``obs`` (float32, on the trainer's
        device), returned as a numpy array."""
        with torch.no_grad():
            a = pol.mean_action(self.net, torch.as_tensor(
                obs, dtype=torch.float32, device=self.device),
                self.n_regions)
        return a.cpu().numpy()
