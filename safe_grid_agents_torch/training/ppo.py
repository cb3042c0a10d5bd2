"""PPO over the array engine, with the advantage estimate and whitening
that every PPO trainer shares.

Counterpart of ``safe_grid_agents_tpu/training/ppo.py`` (``PPOTrainer``,
``compute_gae``, ``_whiten``): the CLI's ``<env> ppo-mlp`` without
``--mxu``, on the uncompiled envs or a ``CompiledEnv``. A chunk:

1. ``collect``: T steps of N lanes; each step samples the actions from the
   policy on the lanes' env states (``PPOAgent.sample_action``: Gumbel-max
   on uniforms from the run's ``torch.Generator``), steps the engine (its
   draws from the same generator) and records the pre-step states (the
   env's state records, stacked to ``[T, N, ...]``), actions, log-probs,
   values, rewards (the hidden ones under ``--cheat``) and dones; with
   ``arrivals=True`` also the pre-reset successors' indices (CRMDP);
2. GAE(λ) bootstrapped from the last states' values, whitened;
3. ``optimize``: ``epochs`` passes over the flat ``[T·N]`` batch, each
   cutting one permutation of it into ``n_minibatches`` minibatches
   (a trailing remainder is dropped), each minibatch one
   ``PPOAgent.update`` (autograd, global-norm clip, Adam); the entropy
   coefficient is the anneal's at the chunk's first step.

The permutations (``[epochs, T·N]``) are an argument of ``optimize``, drawn
with ``torch.randperm`` by ``train_chunk``, so a test can hand over the
reference's ``permutation(key, T·N)``. ``PPOAgent(net="pallas")`` runs its
forward through kernel B11 (``ops/fused_mlp.py``) at ``N`` rows a collect
step and ``T·N / n_minibatches`` rows an update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..agents.ppo import PPOAgent, PPOState, ravel, unravel
from ..envs.array_vec import ArrayVecEnv, VecState, stack_outs
from ..parallel.collectives import pmean_flat
from ..types import map_leaves
from .common import ChunkStats, eval_chunk, reward_source


def whiten(x: torch.Tensor, group=None) -> torch.Tensor:
    """Zero mean, unit scale: ``(x − E[x]) / (sqrt(max(E[x²] − E[x]², 0)) +
    1e-8)``. The variance is the population one, as the reference takes
    it (not ``torch.std``, which is unbiased). Under data parallelism
    (``group``) both moments are averaged over the ranks, so that every
    rank whitens by the global batch's."""
    m = x.mean()
    m2 = torch.square(x).mean()
    if group is not None:
        m, m2 = pmean_flat((m, m2), group)
    var = torch.clamp(m2 - torch.square(m), min=0.0)
    return (x - m) / (torch.sqrt(var) + 1e-8)


def compute_gae(rewards, values, dones, last_value, discount: float,
                lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[T, N]`` inputs → ``(advantages, returns)``, GAE(λ) by a reverse
    loop. Every ``done`` is terminal, timeouts included, as in the
    reference: the bootstrap and the running estimate are masked there."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    adv = torch.empty_like(values)
    for s in range(rewards.shape[0] - 1, -1, -1):
        nonterm = 1.0 - dones[s].to(torch.float32)
        delta = rewards[s] + discount * nonterm * next_value - values[s]
        gae = delta + discount * lam * nonterm * gae
        adv[s] = gae
        next_value = values[s]
    return adv, adv + values


class PPOTrainer:
    def __init__(self, agent: PPOAgent, vec: ArrayVecEnv, cheat: bool = False):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat
        self.device = vec.device

    def init(self, seed: int = 0, generator=None) -> Tuple[PPOState, VecState]:
        """Fresh params and lanes; a coin reset draws from ``generator``."""
        return self.agent.init(self.device, seed), self.vec.reset(generator)

    def lane_states(self, vstate: VecState):
        """What the policy reads of the lanes: the env state record."""
        return vstate.env

    # -- rollout collection ---------------------------------------------------
    def collect(self, astate: PPOState, vstate: VecState, generator, n_steps: int,
                arrivals: bool = False, policy_draws: Optional[torch.Tensor] = None):
        """T sampled steps; returns ``(vstate, stats, traj)`` with ``traj``
        leaves ``[T, N, ...]`` (module doc). ``policy_draws`` ``[T, N, A]``
        hands over the uniforms of the action samples."""
        agent, vec = self.agent, self.vec
        stats = ChunkStats.zero(self.device)
        steps = []
        with torch.no_grad():
            for s in range(n_steps):
                pre = vstate.env
                action, logp, value = agent.sample_action(
                    astate.params, pre, generator,
                    None if policy_draws is None else policy_draws[s])
                vstate, out = vec.step(vstate, action, generator=generator)
                stats = stats.accumulate(out)
                rec = dict(states=pre, actions=action, old_logp=logp, values=value,
                           rewards=reward_source(out, self.cheat), dones=out["done"],
                           observed=out["reward"], hidden=out["hidden_reward"])
                if arrivals:
                    rec["next_idx"] = vec.env.state_index(out["pre_reset_env"])
                steps.append(rec)
        return vstate, stats, stack_outs(steps)

    # -- optimization ---------------------------------------------------------------
    def draw_perms(self, generator, batch_size: int) -> torch.Tensor:
        """``[epochs, batch_size]`` int64 permutations, one per epoch."""
        return torch.stack([torch.randperm(batch_size, generator=generator,
                                           device=self.device)
                            for _ in range(self.agent.epochs)])

    def optimize(self, astate: PPOState, flat: Dict, perms: torch.Tensor,
                 entropy_coef=None, group=None):
        """``epochs`` × ``n_minibatches`` updates over the flat batch (leaves
        ``[B]``; ``states`` an env state record); minibatch ``i`` of epoch
        ``e`` is ``perms[e, i·mb : (i+1)·mb]``. Under data parallelism the
        batch is this rank's and ``group`` averages each update's gradient.
        Returns ``(params, mu, nu, count, loss)``; the loss is the mean over
        epochs of each epoch's mean minibatch loss."""
        agent = self.agent
        mb_size = perms.shape[1] // agent.n_minibatches
        p, mu, nu, count = ravel(astate.params), astate.mu, astate.nu, astate.count
        epoch_losses = []
        for e in range(agent.epochs):
            losses = []
            for i in range(agent.n_minibatches):
                take = perms[e, i * mb_size:(i + 1) * mb_size]
                mb = map_leaves(lambda x: x[take], flat)
                p, mu, nu, loss = agent.update(p, mu, nu, count, mb, entropy_coef, group)
                count = count + 1
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())
        return unravel(p, agent.shapes), mu, nu, count, torch.stack(epoch_losses).mean()

    # -- full chunk -------------------------------------------------------------------
    def _learn(self, astate: PPOState, vstate: VecState, traj: Dict, generator,
               perms: Optional[torch.Tensor], group=None):
        """GAE on ``traj``, whitening, then ``optimize``; returns
        ``(PPOState, loss)``. ``group`` whitens by the global moments and
        averages the gradients over the ranks; the step count advances by
        this rank's batch, as the reference's does."""
        agent = self.agent
        with torch.no_grad():
            _, last_value = agent.policy_value(astate.params, self.lane_states(vstate))
        adv, ret = compute_gae(traj["rewards"], traj["values"], traj["dones"], last_value,
                               agent.discount, agent.gae_lambda)
        batch_size = adv.numel()

        def flatten(x):
            return x.reshape((batch_size,) + tuple(x.shape[2:]))

        flat = {"states": map_leaves(flatten, traj["states"]),
                "actions": flatten(traj["actions"]), "old_logp": flatten(traj["old_logp"]),
                "advantages": flatten(whiten(adv, group)), "returns": flatten(ret)}
        if perms is None:
            perms = self.draw_perms(generator, batch_size)
        params, mu, nu, count, loss = self.optimize(astate, flat, perms,
                                                    agent.entropy_coef(astate.step), group)
        return PPOState(params=params, mu=mu, nu=nu, count=count,
                        step=astate.step + batch_size), loss

    def train_chunk(self, astate: PPOState, vstate: VecState, generator, n_steps: int,
                    perms: Optional[torch.Tensor] = None, group=None):
        """Collect, GAE, optimize; returns ``(astate, vstate, stats, loss)``.
        ``group``: data parallelism (``_learn``)."""
        vstate, stats, traj = self.collect(astate, vstate, generator, n_steps)
        astate, loss = self._learn(astate, vstate, traj, generator, perms, group)
        return astate, vstate, stats, loss

    def eval_chunk(self, astate: PPOState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        with torch.no_grad():
            return eval_chunk(self.vec, lambda a, vs: self.agent.act(a, vs.env), astate,
                              vstate, n_steps, min_episodes=min_episodes,
                              generator=generator)
