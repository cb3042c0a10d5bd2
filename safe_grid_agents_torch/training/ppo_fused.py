"""PPO with the collect phase and the optimize phase each in one CUDA kernel
call per chunk.

Counterpart of ``safe_grid_agents_tpu/training/ppo_pallas.py::
PallasPPOTrainer``: ``MXUPPOTrainer`` with

1. ``collect`` on kernel B5 (``ops/ppo_collect_kernel.py``): the frozen
   actor evaluated once over all S states into policy rows (log-softmax,
   cumulative softmax, value; the reference's ``_collect_payload``) and
   inverse-CDF acting against one ``[T, N]`` uniform draw. On a stochastic
   env (coin and carried resets, whisky's stumble, tomato's drying) the
   uniforms are followed by ``VecEnv.draw_mechanics``'s ``bits, stumble,
   rand_a`` and the collect runs on kernel B10
   (``ops/ppo_stoch_collect_kernel.py``). The trajectory also carries the
   ``observed`` and ``hidden`` rewards and the ``next_idx`` successors, as
   the reference's does;
2. GAE and whitening as inherited;
3. ``optimize_fast`` on kernel B6 (``ops/ppo_kernel.py``): the tile
   shuffle's minibatches stacked epoch by epoch into ``[epochs ·
   n_minibatches, mb_size]`` streams, and every update in one call.

``collect`` and ``optimize_fast`` take their draws (``u [T, N]``, the
mechanics, the permutations ``[epochs, n_tiles]``) as arguments;
``train_chunk`` draws them from its generator unless it is handed them, so
a test can pass in the reference's own draws. Scope: the table-folded net
with two hidden layers on every compiled alias the port has, single
device. Chunk lengths must be multiples of 16, as the reference requires.

``FusedCRMDPTrainer`` is the counterpart of the reference's
``PallasCRMDPTrainer``: this trainer's collect and optimize with
``MXUCRMDPTrainer``'s attribution between them (the same diamond: its
``_learn`` comes from ``MXUCRMDPTrainer`` and calls this ``optimize_fast``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..agents.ppo import PPOAgent, PPOState, ravel, unravel
from ..envs.compiled import TableState
from ..envs.vec import VecEnv, VecState
from ..ops.ppo_collect_kernel import PolicyRows, ppo_collect
from ..ops.ppo_kernel import check_agent, ppo_optimize
from ..ops.ppo_stoch_collect_kernel import ppo_stoch_collect
from ..ops.rollout_kernel import Tables
from .common import ChunkStats
from .ppo_mxu import MXUCRMDPTrainer, MXUPPOTrainer, tile_geometry

TB_P = 16  # the reference collect kernel's T block; chunk lengths are its multiples


class FusedPPOTrainer(MXUPPOTrainer):
    def __init__(self, agent: PPOAgent, vec: VecEnv, cheat: bool = False):
        if agent.net_kind != "table":
            raise ValueError("--fused-kernel ppo needs --table-net (the kernels fold the "
                             "obs table into layer 1)")
        check_agent(agent)
        if agent.env.n_actions + 1 > 8:
            raise ValueError("the fused PPO path packs logits + value into 8 rows, as the "
                             f"reference does; got {agent.env.n_actions} actions")
        super().__init__(agent, vec, cheat=cheat)
        self.S, self.A = vec.S, vec.A
        self.stochastic = vec.stochastic
        self.tables = vec.tables if self.stochastic else Tables.from_env(vec.cenv,
                                                                          vec.reset_idx)
        self._all_states = TableState(
            idx=torch.arange(self.S, dtype=torch.int32, device=self.device),
            t=torch.zeros(self.S, dtype=torch.int32, device=self.device))

    def policy_rows(self, params) -> PolicyRows:
        """The frozen actor over all S states (``_collect_payload``)."""
        with torch.no_grad():
            logits, value = self.agent.policy_value(params, self._all_states)
        return PolicyRows.from_outputs(logits, value)

    def draw_u(self, generator: torch.Generator, n_steps: int) -> torch.Tensor:
        return torch.rand((n_steps, self.vec.n_envs), dtype=torch.float32,
                          generator=generator, device=self.device)

    def collect(self, astate: PPOState, vstate: VecState, u: torch.Tensor, mechanics=None):
        """T steps on kernel B5 with the uniforms ``u [T, N]`` or, on a
        stochastic env, on kernel B10 with ``u`` and ``mechanics = (bits,
        stumble, rand_a)``, each ``[T, N]``; returns ``(vstate, stats,
        traj)`` as ``MXUPPOTrainer.collect`` does."""
        n_steps, n = u.shape
        if n_steps % TB_P:
            raise ValueError(
                f"--chunk-steps {n_steps} must be a multiple of {TB_P} for --fused-kernel "
                "ppo (the reference refuses it too)")
        state = tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                        vstate.ep_hidden, vstate.ep_len))
        rows = self.policy_rows(astate.params)
        if self.stochastic:
            outs = ppo_stoch_collect(self.tables, rows, state, u, *mechanics)
        else:
            outs = ppo_collect(self.tables, rows, state, u)
        (idx, t, epr, eph, epl, eacc, racc, hacc, lacc,
         pidx, pt, act, logp, val, rew, hid, done, nidx) = outs
        traj = {"states": TableState(idx=pidx, t=pt), "actions": act, "old_logp": logp,
                "values": val, "rewards": hid if self.cheat else rew,
                "observed": rew, "hidden": hid, "dones": done.bool(), "next_idx": nidx}
        vstate = VecState(idx=idx[0], t=t[0], ep_return=epr[0], ep_hidden=eph[0],
                          ep_len=epl[0])
        stats = ChunkStats(
            episodes=eacc.sum(), return_sum=racc.sum(), hidden_sum=hacc.sum(),
            length_sum=lacc.sum(),
            env_steps=torch.tensor(float(n_steps * n), device=self.device))
        return vstate, stats, traj

    def optimize_fast(self, astate: PPOState, flat: Dict, perms: torch.Tensor,
                      batch_size: int, entropy_coef=None):
        """Every update on kernel B6; the same membership as
        ``MXUPPOTrainer.optimize_fast``. Returns ``(params, mu, nu, count,
        loss)``."""
        agent = self.agent
        tile, n_tiles, mb_size = tile_geometry(batch_size, agent.n_minibatches)
        used = n_tiles * tile
        n_upd = agent.epochs * agent.n_minibatches

        def stack(x):
            xt = x[:used].reshape(n_tiles, tile)
            return xt[perms[:agent.epochs]].reshape(n_upd, mb_size)

        streams = (stack(flat["states"].idx), stack(flat["actions"]),
                   stack(flat["old_logp"]), stack(flat["advantages"]),
                   stack(flat["returns"]))
        ce = agent.entropy_coef(astate.step) if entropy_coef is None else entropy_coef
        p, mu, nu, count, loss = ppo_optimize(
            agent, ravel(astate.params), astate.mu, astate.nu, astate.count.reshape(1),
            ce.reshape(1).to(torch.float32), streams)
        return unravel(p, agent.shapes), mu, nu, count.reshape(()), loss.reshape(())

    def train_chunk(self, astate: PPOState, vstate: VecState, generator: torch.Generator,
                    n_steps: int, u: Optional[torch.Tensor] = None,
                    perms: Optional[torch.Tensor] = None):
        """Collect on B5 (B10 on a stochastic env), GAE, optimize on B6;
        returns ``(astate, vstate, stats, loss)``. ``u`` and ``perms``
        default to draws from ``generator`` (u first, then a stochastic
        env's mechanics)."""
        if u is None:
            u = self.draw_u(generator, n_steps)
        mechanics = self.vec.draw_mechanics(generator, n_steps) if self.stochastic else None
        vstate, stats, traj = self.collect(astate, vstate, u, mechanics)
        astate, loss = self._learn(astate, vstate, traj, generator, perms)
        return astate, vstate, stats, loss


class FusedCRMDPTrainer(FusedPPOTrainer, MXUCRMDPTrainer):
    """PPO-CRMDP with both phases on kernels: the collect on B5 (B10 on a
    stochastic env such as tomato-crmdp) and the optimize on B6, the
    attribution and relabel between them on the records' ``next_idx``,
    ``observed`` and ``hidden`` (``MXUCRMDPTrainer._learn``). Construction
    runs FusedPPOTrainer's, then MXUCRMDPTrainer's (which refuses ``cheat``),
    then MXUPPOTrainer's. CLI: ``<env> ppo-crmdp --compiled --mxu
    --table-net --fused-kernel``."""
