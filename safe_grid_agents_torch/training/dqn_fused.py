"""DQN with the collect phase and the update phase each in one CUDA kernel
launch per chunk.

Counterpart of ``safe_grid_agents_tpu/training/dqn_pallas.py::
PallasDQNTrainer``, like it a subclass of ``training/dqn_mxu.py::
MXUDQNTrainer`` (``warmup_chunk``, ``train_chunk``, ``eval_chunk`` and,
where the update kernel does not take the net, ``_update_scan``). Each
chunk:

1. evaluates the frozen params once over all S states and takes the
   first-max argmax as the greedy row (``q_values(params, arange(S))``);
2. draws ``rand_a`` and ``u`` (``[T, N]`` each) from the run's
   ``torch.Generator`` and runs the collect kernel
   (``ops/dqn_kernel.py``, B3); on a stochastic env (coin and carried
   resets, whisky's stumble, tomato's drying) it then draws
   ``VecEnv.draw_mechanics``'s ``bits, stumble, rand2`` and runs the
   stochastic collect kernel (``ops/dqn_stoch_kernel.py``, B9) instead.
   Warmup is the same kernel with ε pinned to 1;
3. pushes the records as n-step windows (``training/dqn.py``), with the
   successor's step count ``pre_t + 1`` (the value the MXU trainer stores
   whether or not the step ended the episode);
4. where the update kernel takes the net (uniform replay, two hidden
   layers, at most 8 actions: the reference's eligibility test), draws ONE
   ``[U, B]`` randint over the post-push ring size, gathers the batch and
   runs the update kernel (``ops/dqn_update_kernel.py``, B4); otherwise
   (prioritized replay, other depths, more actions) it runs
   ``MXUDQNTrainer``'s autograd update scan, which under PER samples each
   update after the previous one's priority write.

Greedy eval steps the ``VecEnv`` with the online net's argmax, drawing a
stochastic env's per-step draws (and ``init``'s coin resets) from the
generator it is given. The RNG protocol is this trainer's own (bulk draws
from one generator), so its trajectories are not the JAX trainer's; it is
gated on outcomes.

Scope: every compiled alias the port has, single device, uniform or
prioritized replay, a net of any depth (table-folded or MLP). The chunk and
warmup lengths must be multiples of 16, as the JAX trainer requires, so that
one command is accepted or refused alike by both packages.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..agents.dqn import DQNAgent, DQNState
from ..envs.compiled import TableState
from ..envs.vec import VecEnv
from ..ops.dqn_kernel import CollectHyper, dqn_collect
from ..ops.dqn_stoch_kernel import dqn_stoch_collect
from ..ops.dqn_update_kernel import dqn_update
from ..ops.rollout_kernel import Tables
from ..types import map_fields
from .common import ChunkStats
from .dqn import push_traj_windows
from .dqn_mxu import MXUDQNTrainer

TB_REC = 16  # the JAX collect kernel's T block; chunk lengths are its multiples


def fused_update_fits(agent: DQNAgent) -> bool:
    """Whether the update kernel B4 takes ``agent``'s updates: uniform
    replay, two hidden layers and at most 8 actions (the reference's test,
    ``dqn_pallas.py:117-121``); PER's priorities change between updates."""
    return (not agent.prioritized and len(agent.hidden) == 2
            and agent.env.n_actions <= 8)


class FusedDQNTrainer(MXUDQNTrainer):
    def __init__(self, agent: DQNAgent, vec: VecEnv, cheat: bool = False,
                 updates_per_chunk: int | None = None):
        super().__init__(agent, vec, cheat=cheat, updates_per_chunk=updates_per_chunk)
        self.fused_update = fused_update_fits(agent)
        self.S, self.A = vec.S, vec.A
        self.stochastic = vec.stochastic
        self.tables = vec.tables if self.stochastic else Tables.from_env(vec.cenv,
                                                                          vec.reset_idx)
        self.hyper = CollectHyper(
            float(agent.epsilon), float(agent.epsilon_final),
            float(max(agent.epsilon_anneal_steps, 1)), bool(cheat))
        self._all_states = TableState(
            idx=torch.arange(self.S, dtype=torch.int32, device=self.device),
            t=torch.zeros(self.S, dtype=torch.int32, device=self.device))

    def init(self, seed: int = 0, generator=None) -> Tuple[DQNState, tuple]:
        """Fresh params and lanes as ``(1, N)`` tensors; a coin reset draws
        from ``generator``."""
        vs = self.vec.reset(generator)
        return self.agent.init(self.device, seed), tuple(
            x[None] for x in (vs.idx, vs.t, vs.ep_return, vs.ep_hidden, vs.ep_len))

    def greedy_row(self, params) -> torch.Tensor:
        """First-max argmax of the frozen params' Q over all S states."""
        with torch.no_grad():
            q_all = self.agent.q_values(params, self._all_states)
        return q_all.argmax(-1).to(torch.int32)

    def _collect(self, astate: DQNState, vstate, generator: torch.Generator,
                 n_steps: int, random_policy: bool):
        if n_steps % TB_REC:
            raise ValueError(
                f"chunk and warmup steps ({n_steps}) must be multiples of {TB_REC} "
                "for --fused-kernel deep-q")
        n, dev = self.vec.n_envs, self.device
        rand_a = torch.randint(0, self.A, (n_steps, n), dtype=torch.int32,
                               generator=generator, device=dev)
        u = torch.rand((n_steps, n), dtype=torch.float32, generator=generator, device=dev)
        hyper = self.hyper.warmup() if random_policy else self.hyper
        args = (self.tables, hyper, self.greedy_row(astate.params), vstate,
                astate.step.reshape(1), rand_a, u)
        if self.stochastic:
            outs = dqn_stoch_collect(*args, *self.vec.draw_mechanics(generator, n_steps))
        else:
            outs = dqn_collect(*args)
        (idx, t, epr, eph, epl, step, eacc, racc, hacc, lacc,
         pidx, pt, act, rew, nidx, done) = outs
        traj = (TableState(idx=pidx, t=pt), act, rew,
                TableState(idx=nidx, t=pt + 1), done.bool())
        buffer = push_traj_windows(self.agent, astate.buffer, traj)
        astate = DQNState(
            params=astate.params, target_params=astate.target_params,
            mu=astate.mu, nu=astate.nu, count=astate.count, buffer=buffer,
            step=step.reshape(()), updates=astate.updates)
        stats = ChunkStats(
            episodes=eacc.sum(), return_sum=racc.sum(), hidden_sum=hacc.sum(),
            length_sum=lacc.sum(),
            env_steps=torch.tensor(float(n_steps * n), device=dev))
        return astate, (idx, t, epr, eph, epl), stats

    def _update_scan(self, astate: DQNState, generator: torch.Generator,
                     n_updates: int, slots=None, group=None) -> Tuple[DQNState, torch.Tensor]:
        """``n_updates`` sampled updates in one launch of B4 where it takes
        the net: one randint ``[U, B]`` over the post-push ring (constant
        across the chunk's updates for uniform replay) gathers every
        update's batch. Otherwise ``MXUDQNTrainer``'s autograd scan.
        Single-device, as ``FusedPPOTrainer.optimize_fast`` is."""
        if group is not None:
            raise ValueError("the fused DQN update is single-device; drop --n-devices")
        if not self.fused_update:
            return super()._update_scan(astate, generator, n_updates, slots)
        buf = astate.buffer
        idxs = slots if slots is not None else torch.randint(
            0, max(buf.size, 1), (n_updates, self.agent.batch_size), generator=generator,
            device=self.device)
        batch = map_fields(lambda s: s[idxs], buf.storage)
        params, target, mu, nu, count, updates, loss = dqn_update(
            self.agent, astate.params, astate.target_params, astate.mu, astate.nu,
            astate.count.reshape(1), astate.updates.reshape(1), batch)
        astate = DQNState(
            params=params, target_params=target, mu=mu, nu=nu,
            count=count.reshape(()), buffer=buf, step=astate.step,
            updates=updates.reshape(()))
        return astate, loss.reshape(())
