"""PPO over the table-gather ``VecEnv``: collect, GAE, tile-shuffled
minibatches and the flat clip + Adam.

Counterpart of ``safe_grid_agents_tpu/training/ppo_mxu.py::MXUPPOTrainer``
in its fast mode (the CLI's ``<env> ppo-mlp --compiled --mxu``). A chunk:

1. ``collect``: T steps of N lanes; each step evaluates the policy on the
   lanes' states, samples an action by the Gumbel-max trick from the
   trainer's ``torch.Generator`` (the reference draws
   ``jax.random.categorical``: the same distribution, not the same bits),
   steps the ``VecEnv`` and records ``(states, actions, old_logp, values,
   rewards, dones)``; the reward is the hidden one under ``--cheat``;
2. GAE(λ) with the last states' value as the bootstrap, then whitening;
3. ``optimize_fast``: ``epochs`` passes of ``n_minibatches`` updates. The
   time-major flat batch is cut into tiles of ``TILE`` = 32 adjacent
   elements (halved until it divides the minibatch; a trailing remainder
   is dropped); each epoch permutes the tiles and each minibatch takes a
   contiguous run of the permuted order. Each update is ``PPOAgent.update``
   (autograd, global-norm clip, Adam over the flat params).

The permutations are an argument of ``optimize_fast`` (``[epochs,
n_tiles]``) that ``train_chunk`` draws with ``torch.randperm``, so a test
can hand in the reference's ``permutation(fold_in(key, e), n_tiles)``.
The reference's parity mode (``--mxu-parity``: the base optimize with an
element permutation) is not ported (ROADMAP A.10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..agents.ppo import PPOAgent, PPOState, ravel, unravel
from ..envs.compiled import TableState
from ..envs.vec import VecEnv, VecState
from .common import ChunkStats, eval_chunk
from .ppo import compute_gae, whiten

TILE = 32  # flat elements per shuffle tile (adjacent lanes of one step)


def tile_geometry(batch_size: int, n_minibatches: int) -> Tuple[int, int, int]:
    """``(tile, n_tiles, mb_size)`` of the tile shuffle."""
    mb_size = batch_size // n_minibatches
    tile = TILE
    while mb_size % tile:
        tile //= 2
    return tile, n_minibatches * mb_size // tile, mb_size


class MXUPPOTrainer:
    def __init__(self, agent: PPOAgent, vec: VecEnv, cheat: bool = False):
        self.agent = agent
        self.vec = vec
        self.cheat = cheat
        self.device = vec.device

    def init(self, seed: int = 0) -> Tuple[PPOState, VecState]:
        return self.agent.init(self.device, seed), self.vec.reset()

    def draw_perms(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``[epochs, n_tiles]`` int64 tile permutations, one per epoch."""
        _, n_tiles, _ = tile_geometry(batch_size, self.agent.n_minibatches)
        return torch.stack([
            torch.randperm(n_tiles, generator=generator, device=self.device)
            for _ in range(self.agent.epochs)])

    # -- rollout collection ---------------------------------------------------
    def collect(self, astate: PPOState, vstate: VecState, generator: torch.Generator,
                n_steps: int):
        """T sampled steps; returns ``(vstate, stats, traj)`` with ``traj``
        leaves ``[T, N]``."""
        agent = self.agent
        stats = ChunkStats.zero(self.device)
        recs: Dict[str, list] = {k: [] for k in (
            "idx", "t", "actions", "old_logp", "values", "rewards", "dones")}
        tiny = torch.finfo(torch.float32).tiny
        with torch.no_grad():
            for _ in range(n_steps):
                pre = TableState(idx=vstate.idx, t=vstate.t)
                logits, value = agent.policy_value(astate.params, pre)
                u = torch.rand(logits.shape, generator=generator, device=self.device)
                gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
                action = (logits + gumbel).argmax(-1).to(torch.int32)
                logp = torch.log_softmax(logits, -1)
                logp_a = logp.gather(-1, action.long()[:, None]).squeeze(-1)
                vstate, out = self.vec.step(vstate, action)
                stats = stats.accumulate(out)
                for k, x in (("idx", pre.idx), ("t", pre.t), ("actions", action),
                             ("old_logp", logp_a), ("values", value),
                             ("rewards", out["hidden_reward"] if self.cheat else out["reward"]),
                             ("dones", out["done"])):
                    recs[k].append(x)
        traj = {k: torch.stack(v) for k, v in recs.items()}
        traj["states"] = TableState(idx=traj.pop("idx"), t=traj.pop("t"))
        return vstate, stats, traj

    # -- fast optimize ----------------------------------------------------------
    def optimize_fast(self, astate: PPOState, flat: Dict, perms: torch.Tensor,
                      batch_size: int, entropy_coef=None):
        """Tile-shuffled minibatch updates over the time-major ``flat``
        batch (leaves ``[batch_size]``; ``states`` a ``TableState``).
        Returns ``(params, mu, nu, count, loss)``; the loss is the mean
        over epochs of each epoch's mean minibatch loss."""
        agent = self.agent
        tile, n_tiles, mb_size = tile_geometry(batch_size, agent.n_minibatches)
        mb_tiles = mb_size // tile
        used = n_tiles * tile

        def tiles(x):
            return x[:used].reshape(n_tiles, tile)

        flat_t = {"states": TableState(idx=tiles(flat["states"].idx), t=tiles(flat["states"].t)),
                  **{k: tiles(flat[k]) for k in ("actions", "old_logp", "advantages", "returns")}}
        p = ravel(astate.params)
        mu, nu, count = astate.mu, astate.nu, astate.count
        epoch_losses = []
        for e in range(agent.epochs):
            losses = []
            for i in range(agent.n_minibatches):
                rows = perms[e, i * mb_tiles:(i + 1) * mb_tiles]

                def take(x):
                    return x[rows].reshape(mb_size)

                mb = {"states": TableState(idx=take(flat_t["states"].idx),
                                           t=take(flat_t["states"].t)),
                      **{k: take(flat_t[k]) for k in ("actions", "old_logp",
                                                      "advantages", "returns")}}
                p, mu, nu, loss = agent.update(p, mu, nu, count, mb, entropy_coef)
                count = count + 1
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())
        return unravel(p, agent.shapes), mu, nu, count, torch.stack(epoch_losses).mean()

    # -- full chunk ---------------------------------------------------------------
    def _learn(self, astate: PPOState, vstate: VecState, traj: Dict,
               generator: torch.Generator, perms: Optional[torch.Tensor]):
        """GAE on the collected ``traj``, whitening, then ``optimize_fast``;
        returns ``(astate, loss)``."""
        agent = self.agent
        with torch.no_grad():
            _, last_value = agent.policy_value(astate.params,
                                               TableState(idx=vstate.idx, t=vstate.t))
        adv, ret = compute_gae(traj["rewards"], traj["values"], traj["dones"], last_value,
                               agent.discount, agent.gae_lambda)
        batch_size = adv.numel()

        def flatten(x):
            return x.reshape(batch_size)

        flat = {"states": TableState(idx=flatten(traj["states"].idx),
                                     t=flatten(traj["states"].t)),
                "actions": flatten(traj["actions"]), "old_logp": flatten(traj["old_logp"]),
                "advantages": flatten(whiten(adv)), "returns": flatten(ret)}
        if perms is None:
            perms = self.draw_perms(generator, batch_size)
        params, mu, nu, count, loss = self.optimize_fast(
            astate, flat, perms, batch_size, agent.entropy_coef(astate.step))
        return PPOState(params=params, mu=mu, nu=nu, count=count,
                        step=astate.step + batch_size), loss

    def train_chunk(self, astate: PPOState, vstate: VecState, generator: torch.Generator,
                    n_steps: int, perms: Optional[torch.Tensor] = None):
        """Collect, GAE, optimize; returns ``(astate, vstate, stats, loss)``.
        ``perms`` defaults to ``draw_perms(generator, T·N)``."""
        vstate, stats, traj = self.collect(astate, vstate, generator, n_steps)
        astate, loss = self._learn(astate, vstate, traj, generator, perms)
        return astate, vstate, stats, loss

    def eval_chunk(self, astate: PPOState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None):
        """Greedy eval on the ``VecEnv`` from ``vstate`` (the CLI passes a
        fresh ``vec.reset()``)."""
        with torch.no_grad():
            return eval_chunk(self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate,
                              vstate, n_steps, min_episodes=min_episodes)
