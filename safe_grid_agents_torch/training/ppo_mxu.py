"""PPO over the table-gather ``VecEnv``: collect, GAE, tile-shuffled
minibatches and the flat clip + Adam.

Counterpart of ``safe_grid_agents_tpu/training/ppo_mxu.py::MXUPPOTrainer``
in both its modes (the CLI's ``<env> ppo-mlp|ppo-cnn --compiled --mxu``,
``--mxu-parity`` for ``mode="parity"``). A chunk:

1. ``collect``: T steps of N lanes; each step evaluates the policy on the
   lanes' states, samples an action by the Gumbel-max trick from the
   trainer's ``torch.Generator`` (the reference draws
   ``jax.random.categorical``: the same distribution, not the same bits),
   steps the ``VecEnv`` and records ``(states, actions, old_logp, values,
   rewards, dones)``; the reward is the hidden one under ``--cheat``. The
   trajectory also carries the ``observed`` and ``hidden`` rewards and the
   ``next_idx`` arrival states (pre-reset), which CRMDP's attribution
   reads. On a
   stochastic env each step then draws ``VecEnv.draw_mechanics(generator,
   1)`` for the step (the recorded action is the CHOSEN one; whisky's
   stumble may step the env with another);
2. GAE(λ) with the last states' value as the bootstrap, then whitening;
3. ``mode="fast"`` (the default), ``optimize_fast``: ``epochs`` passes of
   ``n_minibatches`` updates. The
   time-major flat batch is cut into tiles of ``TILE`` = 32 adjacent
   elements (halved until it divides the minibatch; a trailing remainder
   is dropped); each epoch permutes the tiles and each minibatch takes a
   contiguous run of the permuted order. Each update is ``PPOAgent.update``
   (autograd, global-norm clip, Adam over the flat params).
   ``mode="parity"``: the base ``PPOTrainer``'s element permutations
   (``draw_perms``) and ``optimize``. The collect draws from the generator
   in the base collect's order (the policy's uniforms, then the step's
   mechanics, which ``VecEnv.draw_mechanics`` draws as the env's own
   methods do), so a parity chunk is bitwise the base ``PPOTrainer``'s over
   ``ArrayVecEnv`` on the same compiled env and generator: the check that
   the fast path runs the same algorithm.

The permutations are an argument of ``optimize`` (``[epochs, n_tiles]``
tile or ``[epochs, T·N]`` element permutations) that ``train_chunk`` draws
with ``torch.randperm``, so a test can hand in the reference's.

GAE, whitening and the flat batch are ``PPOTrainer._learn``'s, which calls
``optimize`` (``optimize_fast`` here). ``MXUCRMDPTrainer`` (PPO-CRMDP) runs
the corruption attribution and the reward relabel between collect and GAE
(``crmdp.Attribution``), as the base ``CRMDPTrainer`` and the fused
``FusedCRMDPTrainer`` (``training/ppo_fused.py``) do: one attribution
path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..agents.ppo import PPOState, ravel, unravel
from ..envs.compiled import TableState
from ..envs.vec import VecState
from .common import ChunkStats, eval_chunk, reward_source
from .crmdp import Attribution
from .ppo import PPOTrainer

TILE = 32  # flat elements per shuffle tile (adjacent lanes of one step)


def tile_geometry(batch_size: int, n_minibatches: int) -> Tuple[int, int, int]:
    """``(tile, n_tiles, mb_size)`` of the tile shuffle."""
    mb_size = batch_size // n_minibatches
    tile = TILE
    while mb_size % tile:
        tile //= 2
    return tile, n_minibatches * mb_size // tile, mb_size


class MXUPPOTrainer(PPOTrainer):
    """``PPOTrainer`` over the compiled engine: its own collect (the lanes
    are indices) and, in fast mode, tile permutations and optimize; GAE,
    whitening and the chunk's shape are the base trainer's
    (``PPOTrainer._learn``)."""

    def __init__(self, agent, vec, cheat: bool = False, mode: str = "fast"):
        if mode not in ("fast", "parity"):
            raise ValueError(f"mode must be 'fast' or 'parity', got {mode!r}")
        super().__init__(agent, vec, cheat=cheat)
        self.mode = mode

    def lane_states(self, vstate: VecState) -> TableState:
        return TableState(idx=vstate.idx, t=vstate.t)

    def draw_perms(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``[epochs, n_tiles]`` int64 tile permutations, one per epoch (in
        parity mode the base trainer's element permutations)."""
        if self.mode == "parity":
            return super().draw_perms(generator, batch_size)
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
            "idx", "t", "actions", "old_logp", "values", "rewards", "dones", "observed",
            "hidden", "next_idx")}
        with torch.no_grad():
            for _ in range(n_steps):
                pre = TableState(idx=vstate.idx, t=vstate.t)
                action, logp_a, value = agent.sample_action(astate.params, pre, generator)
                draws = None
                if self.vec.stochastic:
                    draws = tuple(d[0] for d in self.vec.draw_mechanics(generator, 1))
                vstate, out = self.vec.step(vstate, action, draws)
                stats = stats.accumulate(out)
                for k, x in (("idx", pre.idx), ("t", pre.t), ("actions", action),
                             ("old_logp", logp_a), ("values", value),
                             ("rewards", reward_source(out, self.cheat)),
                             ("dones", out["done"]), ("observed", out["reward"]),
                             ("hidden", out["hidden_reward"]), ("next_idx", out["next_idx"])):
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

    def optimize(self, astate: PPOState, flat: Dict, perms: torch.Tensor,
                 entropy_coef=None):
        """``optimize_fast`` over the whole flat batch, or in parity mode the
        base trainer's ``optimize`` (``PPOTrainer._learn`` calls this)."""
        if self.mode == "parity":
            return super().optimize(astate, flat, perms, entropy_coef)
        return self.optimize_fast(astate, flat, perms, flat["actions"].shape[0], entropy_coef)

    def eval_chunk(self, astate: PPOState, vstate: VecState, n_steps: int,
                   min_episodes: int | None = None, generator=None):
        """Greedy eval on the ``VecEnv`` from ``vstate`` (the CLI passes a
        fresh ``vec.reset(generator)``); a stochastic env draws from
        ``generator``."""
        with torch.no_grad():
            return eval_chunk(self.vec, lambda a, vs: self.agent.act_idx(a, vs.idx), astate,
                              vstate, n_steps, min_episodes=min_episodes,
                              generator=generator)


class MXUCRMDPTrainer(Attribution, MXUPPOTrainer):
    """PPO-CRMDP over the table-gather ``VecEnv`` (counterpart of the
    reference's ``MXUCRMDPTrainer``, either mode): a chunk is collect →
    ``update_corruption`` → ``relabel`` → GAE on the relabeled rewards →
    whitening → optimize (``crmdp.Attribution``). CRMDP trains on the
    observed rewards, relabeled, so ``cheat`` is refused."""
