"""Decompositions of the port's engines and learners: the counterpart of the
repo's ``tools/diag.py``, with its nine subcommands, flags, defaults and row
labels.

    python -m safe_grid_agents_torch.tools.diag <subcommand> [flags] [--platform cpu] \\
        [--out FILE]

Every row is the median of at least 5 calls after one warm-up call, timed
with CUDA events behind ``torch.cuda.synchronize`` (``learner_cases.
event_ms``, as ``trace_learners`` and ``ab_learners`` time), and printed to
standard error as ``label  ms  (min)  [-> M steps/s]``; ``--out`` writes the
rows as JSON. With ``--platform cpu`` the rows run at a toy size (unless
sizes are given) and are host wall-clock times: no time there is a device
time. The reference's labels are kept where the row measures the same
thing; "xla-mxu" and "construct" name the port's compiled engine
(``envs/vec.py::VecEnv``), "pallas" and "kernel" its kernel engines.

  ppo-decomp      the island table-net chunk of the base ``PPOTrainer`` (over
                  the compiled tables) by phase: full chunk, collect on both
                  engines, ``opt/full`` with ms per minibatch update,
                  ``opt/fixed-minibatch``, ``opt/gradonly``, ``perm only``,
                  ``gather only``; then the fused trainer's chunk (B5, B6)
                  split into collect, optimize and the host side between
  ppo-candidates  env-slice minibatches with per-parameter Adam against the
                  flat Adam over the raveled parameters (the port's update)
  ppo-e2e         ``MXUPPOTrainer`` (fast mode) end to end: single chunks and
                  superchunks (K chunks back to back)
  ppo-lanes       the MXU PPO trainer's lane-width scan
  dqn-decomp      the MXU DQN chunk by phase: collect + push, collect
                  without push, the update scan and its parts (sample,
                  fwd+bwd, Adam), a flat-Adam candidate; then the fused
                  trainer's chunk (B3, B4) split into collect and updates
  engine-carry    the one-hot-carry candidate engine (``oh @ P_a``) against
                  the compiled engine, deterministic aliases
  engine-pallas   B1 (``RolloutEngine.run_random_reduced``) against the
                  compiled engine's ``run_random_reduced``: same protocol,
                  same generator state, totals equal
  ppo-kernel-opt  B6 (``FusedPPOTrainer.optimize_fast``) against
                  ``MXUPPOTrainer.optimize_fast`` on one flat rollout
  engine-stoch    B7 against the compiled engine on absent, interrupt,
                  whisky, friend (cap 15) and tomato, totals equal

XLA's scan ``unroll`` has no counterpart in eager PyTorch: where the
reference times unroll 1 against 4, one row runs and a line says so.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ..device import platform_device

ROWS: list = []
DEVICE = torch.device("cpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync():
    if DEVICE.type == "cuda":
        torch.cuda.synchronize(DEVICE)


def _call_ms(fn) -> float:
    if DEVICE.type == "cuda":
        from .learner_cases import event_ms

        torch.cuda.synchronize(DEVICE)
        return event_ms(fn)[0]
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bench(fn, label: str, n_iter: int = 6, steps_per_call=None) -> float:
    """Median ms of ``fn()`` over ``n_iter`` (≥ 5) calls after a warm-up;
    prints and records the row, returns the median in seconds."""
    fn()
    _sync()
    times = [_call_ms(fn) for _ in range(max(5, n_iter))]
    med = statistics.median(times)
    rate = ""
    if steps_per_call:
        rate = f"  -> {steps_per_call / med / 1e3:8.2f} M steps/s"
    log(f"{label:34s} {med:9.2f} ms  (min {min(times):.2f}){rate}")
    ROWS.append({"label": label, "ms": med, "min_ms": min(times), "calls": len(times),
                 "steps_per_call": steps_per_call})
    return med / 1e3


def note(text: str) -> None:
    log(f"  ({text})")
    ROWS.append({"note": text})


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def _size(value, full, toy):
    """A flag's value: as given, else the reference's default on the card
    and a toy size on the CPU."""
    if value is not None:
        return value
    return toy if DEVICE.type == "cpu" else full


# --------------------------------------------------------------------------
# ppo-decomp
# --------------------------------------------------------------------------
def _island_table_agent():
    from ..agents.ppo import PPOAgent
    from ..envs import make_env

    env = make_env("island", compiled=True, device=DEVICE)
    return env, PPOAgent(env, net="table")


def _random_flat(env, B: int, seed: int):
    from ..envs.compiled import TableState

    g = _gen(seed)
    return {
        "states": TableState(
            idx=torch.randint(0, env.num_states, (B,), dtype=torch.int32, generator=g,
                              device=DEVICE),
            t=torch.zeros((B,), dtype=torch.int32, device=DEVICE)),
        "actions": torch.randint(0, env.n_actions, (B,), dtype=torch.int32, generator=g,
                                 device=DEVICE),
        "old_logp": torch.full((B,), -1.38, dtype=torch.float32, device=DEVICE),
        "advantages": torch.randn((B,), generator=g, device=DEVICE),
        "returns": torch.randn((B,), generator=g, device=DEVICE),
    }


def ppo_decomp(args):
    from ..agents.ppo import ravel, unravel
    from ..envs.array_vec import ArrayVecEnv
    from ..envs.vec import VecEnv
    from ..training import FusedPPOTrainer, MXUPPOTrainer, PPOTrainer
    from ..types import map_leaves

    N, T = _size(args.n_envs, 4096, 32), _size(args.t, 64, 16)
    B = N * T
    env, agent = _island_table_agent()
    trainer = PPOTrainer(agent, ArrayVecEnv(env, N))
    g = _gen(0)
    astate, vstate = trainer.init(seed=0, generator=g)

    bench(lambda: trainer.train_chunk(astate, vstate, g, T), "chunk/full", steps_per_call=B)
    bench(lambda: trainer.collect(astate, vstate, g, T), "collect/vec")
    mxu = MXUPPOTrainer(agent, VecEnv(env, N))
    mstate = mxu.vec.reset(_gen(1))
    bench(lambda: mxu.collect(astate, mstate, g, T), "collect/mxu")

    flat = _random_flat(env, B, 3)
    ce = agent.entropy_coef(astate.step)
    perms = trainer.draw_perms(g, B)
    t_opt = bench(lambda: trainer.optimize(astate, flat, perms, ce), "opt/full")
    n_updates = agent.epochs * agent.n_minibatches
    log(f"  -> {t_opt * 1e3 / n_updates:.2f} ms/minibatch-update")
    ROWS.append({"label": "opt/full per minibatch update", "ms": t_opt * 1e3 / n_updates})

    mb_size = B // agent.n_minibatches
    mb0 = map_leaves(lambda x: x[:mb_size], flat)

    def opt_fixed():
        p, mu, nu, count = ravel(astate.params), astate.mu, astate.nu, astate.count
        for _ in range(n_updates):
            p, mu, nu, loss = agent.update(p, mu, nu, count, mb0, ce)
            count = count + 1
        return loss

    bench(opt_fixed, "opt/fixed-minibatch")

    def opt_gradonly():
        s = torch.zeros((), device=DEVICE)
        for _ in range(n_updates):
            leaf = ravel(astate.params).detach().requires_grad_(True)
            loss = agent.loss(unravel(leaf, agent.shapes), mb0, ce)
            torch.autograd.grad(loss, [leaf])
            s = s + loss.detach()
        return s

    bench(opt_gradonly, "opt/gradonly")
    bench(lambda: trainer.draw_perms(g, B), "perm only")

    def gather_only():
        perm = torch.randperm(B, generator=g, device=DEVICE)
        s = torch.zeros((), device=DEVICE)
        for u in range(n_updates):
            i = u % agent.n_minibatches
            take = perm[i * mb_size:(i + 1) * mb_size]
            s = s + map_leaves(lambda x: x[take], flat)["advantages"].sum()
        return s

    bench(gather_only, "gather only")

    # The fused trainer's chunk (the CLI's --fused-kernel: B5, then B6): the
    # host side is the chunk less its collect and its optimize (GAE,
    # whitening, the flat batch, the tile permutations, the launch paths).
    fused = FusedPPOTrainer(agent, VecEnv(env, N))
    fstate = fused.vec.reset(_gen(1))
    t_fchunk = bench(lambda: fused.train_chunk(astate, fstate, g, T), "fused chunk/full",
                     steps_per_call=B)
    u = fused.draw_u(g, T)
    t_fcol = bench(lambda: fused.collect(astate, fstate, u), "fused collect (B5)")
    tperms = fused.draw_perms(g, B)
    t_fopt = bench(lambda: fused.optimize_fast(astate, flat, tperms, B, ce),
                   "fused opt (B6)")
    host = t_fchunk - t_fcol - t_fopt
    log(f"  -> fused host side (chunk - collect - opt): {host * 1e3:.2f} ms")
    ROWS.append({"label": "fused host side", "ms": host * 1e3})


# --------------------------------------------------------------------------
# ppo-candidates
# --------------------------------------------------------------------------
def ppo_candidates(args):
    from ..agents.ppo import ravel
    from ..envs.vec import VecEnv
    from ..ops.dqn_update_kernel import UpdateHyper, adam_reference
    from ..training import MXUPPOTrainer
    from ..types import map_leaves

    N = _size(args.n_envs, 4096, 32)
    env, agent = _island_table_agent()
    mxu = MXUPPOTrainer(agent, VecEnv(env, N))
    astate = agent.init(DEVICE, 0)
    mstate = mxu.vec.reset(_gen(1))
    g = _gen(0)
    t_col = _size(None, 64, 8)
    bench(lambda: mxu.collect(astate, mstate, g, t_col), f"collect T={t_col} unroll=1")
    note("unroll=4: XLA's scan unroll has no counterpart in eager PyTorch; not run")

    n_mb = agent.n_minibatches
    ce = agent.entropy_coef(astate.step)
    hyper = UpdateHyper(lr=agent.lr, gamma_n=1.0, sync_every=1, double_q=False)

    def make_envslice(T, flat_params):
        B = N * T
        mb_size = B // n_mb
        flat = _random_flat(env, B, 3)
        names = sorted(astate.params)

        def minibatches():
            for _ in range(agent.epochs):
                for i in range(n_mb):
                    yield map_leaves(lambda x: x[i * mb_size:(i + 1) * mb_size], flat)

        if flat_params:
            def opt():  # the port's update: one flat vector, clip + Adam
                p, mu, nu, count = ravel(astate.params), astate.mu, astate.nu, astate.count
                for mb in minibatches():
                    p, mu, nu, loss = agent.update(p, mu, nu, count, mb, ce)
                    count = count + 1
                return loss
            return opt

        def opt():  # per-parameter: a gradient, clip and Adam step per leaf
            params = {k: v.detach() for k, v in astate.params.items()}
            mu = {k: torch.zeros_like(v) for k, v in params.items()}
            nu = {k: torch.zeros_like(v) for k, v in params.items()}
            for t, mb in enumerate(minibatches(), 1):
                leaves = {k: params[k].detach().requires_grad_(True) for k in names}
                loss = agent.loss(leaves, mb, ce)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                gn = torch.sqrt(sum((x * x).sum() for x in grads))
                scale = torch.clamp(agent.max_grad_norm / gn, max=1.0)
                tt = torch.tensor(float(t), device=DEVICE)
                for k, gk in zip(names, grads):
                    params[k], mu[k], nu[k] = adam_reference(params[k], mu[k], nu[k],
                                                             gk * scale, tt, hyper)
            return loss
        return opt

    bench(make_envslice(_size(None, 64, 8), False), f"opt T={_size(None, 64, 8)} envslice")
    bench(make_envslice(_size(None, 64, 8), True), f"opt T={_size(None, 64, 8)} envslice flat")
    bench(make_envslice(_size(None, 128, 16), True),
          f"opt T={_size(None, 128, 16)} envslice flat")
    note("the reference's flat rows run at unroll=4; here each is one eager loop")


# --------------------------------------------------------------------------
# ppo-e2e, ppo-lanes
# --------------------------------------------------------------------------
def _mxu_ppo(N):
    from ..envs.vec import VecEnv
    from ..training import MXUPPOTrainer

    env, agent = _island_table_agent()
    trainer = MXUPPOTrainer(agent, VecEnv(env, N), mode="fast")
    g = _gen(1)
    astate, mstate = trainer.init(seed=0, generator=_gen(0))
    return trainer, astate, mstate, g


def _superchunk(trainer, astate, mstate, g, K, T):
    def f():
        a, m = astate, mstate
        for _ in range(K):
            a, m, _, loss = trainer.train_chunk(a, m, g, T)
        return loss
    return f


def ppo_e2e(args):
    N = _size(args.n_envs, 4096, 32)
    trainer, astate, mstate, g = _mxu_ppo(N)
    ts = (_size(None, 64, 8), _size(None, 128, 16))
    for T in ts:
        bench(lambda: trainer.train_chunk(astate, mstate, g, T), f"fast chunk T={T}",
              steps_per_call=N * T)
    for K, T in ((_size(None, 4, 2), ts[0]), (_size(None, 16, 4), ts[0]),
                 (_size(None, 8, 2), ts[1])):
        bench(_superchunk(trainer, astate, mstate, g, K, T), f"superchunk K={K} T={T}",
              steps_per_call=N * T * K)


def ppo_lanes(args):
    T, K = _size(args.t, 64, 8), _size(args.k, 8, 2)
    for N in _size(args.lanes, [4096, 8192, 16384, 32768], [32, 64]):
        trainer, astate, mstate, g = _mxu_ppo(N)
        bench(_superchunk(trainer, astate, mstate, g, K, T),
              f"N={N} T={T} K={K} mb={N * T // 16}", steps_per_call=N * T * K)


# --------------------------------------------------------------------------
# dqn-decomp
# --------------------------------------------------------------------------
def dqn_decomp(args):
    from ..agents.dqn import DQNAgent
    from ..envs import make_env
    from ..envs.compiled import TableState
    from ..envs.vec import VecEnv
    from ..ops.dqn_update_kernel import UpdateHyper, adam_reference
    from ..training import FusedDQNTrainer, MXUDQNTrainer
    from ..utils import replay

    N, T = _size(args.n_envs, 4096, 32), _size(args.t, 256, 16)
    U = max(1, T // 8)  # the reference's bench geometry: one update per 8 steps
    env = make_env("sokoban", compiled=True, device=DEVICE)
    agent = DQNAgent(env, replay_capacity=1 << 20, batch_size=_size(None, 1024, 64))
    trainer = MXUDQNTrainer(agent, VecEnv(env, N), updates_per_chunk=U)
    g = _gen(1)
    astate, mstate = trainer.init(seed=0, generator=_gen(0))
    astate, mstate, _ = trainer.warmup_chunk(astate, mstate, g, 16)

    bench(lambda: trainer.train_chunk(astate, mstate, g, T), f"chunk/full T={T} U={U}",
          steps_per_call=N * T)
    bench(lambda: trainer._collect(astate, mstate, g, T, False), f"collect+push T={T}",
          steps_per_call=N * T)

    def col_nopush():
        st = mstate
        r = torch.zeros((), device=DEVICE)
        with torch.no_grad():
            for _ in range(T):
                pre = TableState(idx=st.idx, t=st.t)
                rand_a, u = agent.draw_explore(N, g, DEVICE)
                st, out = trainer.vec.step(st, agent.act_explore(astate, pre, rand_a, u))
                r = r + out["reward"].sum()
        return r

    bench(col_nopush, f"collect/nopush T={T}")

    t_upd = bench(lambda: trainer._update_scan(astate, g, U), f"updates U={U} (base pytree)")
    log(f"  -> {t_upd * 1e3 / U:.2f} ms/update")

    hyper = UpdateHyper.from_agent(agent)
    names = list(astate.params)
    shapes = [astate.params[k].shape for k in names]
    sizes = [astate.params[k].numel() for k in names]

    def flat_updates():
        # Candidate: one flat Adam over the raveled parameters (the
        # reference's shipped scan) instead of one per parameter.
        p = torch.cat([astate.params[k].reshape(-1) for k in names])
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        target = astate.target_params
        for u in range(U):
            slots = replay.sample_slots(astate.buffer, g, agent.batch_size)
            leaf = p.detach().requires_grad_(True)
            params = {k: x.view(s) for k, x, s in zip(names, leaf.split(sizes), shapes)}
            loss = agent.td_loss(params, target, replay.gather(astate.buffer, slots))
            (grad,) = torch.autograd.grad(loss, [leaf])
            p, m, v = adam_reference(p.detach(), m, v, grad,
                                     torch.tensor(float(u + 1), device=DEVICE), hyper)
        return loss

    t_flat = bench(flat_updates, f"updates U={U} (flat candidate)")
    log(f"  -> {t_flat * 1e3 / U:.2f} ms/update")

    batch = replay.gather(astate.buffer, replay.sample_slots(astate.buffer, g,
                                                             agent.batch_size))

    def sample_only():
        s = torch.zeros((), device=DEVICE)
        for _ in range(U):
            b = replay.sample(astate.buffer, g, agent.batch_size)
            s = s + b.reward.sum()
        return s

    bench(sample_only, "sample only xU")

    def fwdbwd_only():
        s = torch.zeros((), device=DEVICE)
        for _ in range(U):
            leaves = {k: v.detach().requires_grad_(True) for k, v in astate.params.items()}
            loss = agent.td_loss(leaves, astate.target_params, batch)
            torch.autograd.grad(loss, list(leaves.values()))
            s = s + loss.detach()
        return s

    bench(fwdbwd_only, "td fwd+bwd only xU")

    leaves = {k: v.detach().requires_grad_(True) for k, v in astate.params.items()}
    grads = dict(zip(names, torch.autograd.grad(
        agent.td_loss(leaves, astate.target_params, batch), [leaves[k] for k in names])))

    def adam_only():
        params, mu, nu = dict(astate.params), dict(astate.mu), dict(astate.nu)
        for u in range(U):
            t = torch.tensor(float(u + 1), device=DEVICE)
            for k in names:
                params[k], mu[k], nu[k] = adam_reference(params[k], mu[k], nu[k], grads[k],
                                                         t, hyper)
        return params[names[0]].sum()

    bench(adam_only, "adam only xU (pytree)")

    bench(lambda: trainer.train_chunk(astate, mstate, g, T), "chunk/flat unroll=1",
          steps_per_call=N * T)
    note("unroll=4: XLA's scan unroll has no counterpart in eager PyTorch; not run")

    def superchunk(K):
        def f():
            a, m = astate, mstate
            for _ in range(K):
                a, m, _, loss = trainer.train_chunk(a, m, g, T)
            return loss
        return f

    bench(superchunk(8), "superchunk K=8", steps_per_call=N * T * 8)

    # The fused trainer's chunk (the CLI's --fused-kernel): B3's collect,
    # then B4's U updates in one launch (its autograd scan where B4 does
    # not take the net).
    fused = FusedDQNTrainer(agent, VecEnv(env, N), updates_per_chunk=U)
    fa, fs = fused.init(seed=0, generator=_gen(0))
    fa, fs, _ = fused.warmup_chunk(fa, fs, g, 16)
    bench(lambda: fused.train_chunk(fa, fs, g, T), f"fused chunk/full T={T} U={U}",
          steps_per_call=N * T)
    bench(lambda: fused._collect(fa, fs, g, T, False), f"fused collect+push T={T} (B3)")
    bench(lambda: fused._update_scan(fa, g, U),
          f"fused updates U={U} ({'B4' if fused.fused_update else 'autograd scan'})")


# --------------------------------------------------------------------------
# engine-carry
# --------------------------------------------------------------------------
def engine_carry(args):
    """Candidate engine: the state is a one-hot row ``oh [N, S]`` advanced
    by per-action permutation products (``oh' = oh @ P_a``, exact 0/1 in
    bf16), packed with the reward and done columns into ``W [S, A·(S+2)]``;
    a reset selects the basis row. Against the compiled engine on the same
    ``[T, N]`` action draw (the reward totals must be equal).
    Deterministic-reset aliases only."""
    from ..envs import make_env
    from ..envs.vec import VecEnv

    cenv = make_env("shift", compiled=True, device=DEVICE)
    S, A = cenv.num_states, cenv.n_actions
    F = S + 2
    nxt, rew = cenv.next_table.long().cpu(), cenv.reward_table.float().cpu()
    W = torch.zeros((S, A * F), dtype=torch.float32)
    for a in range(A):
        W[torch.arange(S), a * F + nxt[:, a]] = 1.0
        W[:, a * F + S] = rew[:, a]
        W[:, a * F + S + 1] = cenv.done_table[:, a].float().cpu()
    bf_ok = torch.equal(W.to(torch.bfloat16).to(torch.float32), W)
    dtype = torch.bfloat16 if bf_ok and DEVICE.type == "cuda" else torch.float32
    Wd = W.to(DEVICE, dtype)
    max_steps = int(cenv.max_steps)
    T = _size(args.t, 1024, 64)

    for N in _size(args.lanes, [4096, 65536], [64]):
        mxu = VecEnv(cenv, N)
        st0 = mxu.reset()
        bench(lambda: mxu.run_random_reduced(st0, _gen(1), T), f"construct N={N}",
              n_iter=5, steps_per_call=N * T)
        reset_row = torch.zeros((S,), dtype=dtype, device=DEVICE)
        reset_row[mxu.reset_idx] = 1

        def carry_run():
            actions = torch.randint(0, A, (T, N), dtype=torch.int32, generator=_gen(1),
                                    device=DEVICE)
            oh = reset_row.expand(N, S).clone()
            t = torch.zeros((N,), dtype=torch.int32, device=DEVICE)
            acc = torch.zeros((), dtype=torch.float32, device=DEVICE)
            for row in actions:
                y = (oh @ Wd).float().view(N, A, F)
                f = y.gather(1, row.long().view(N, 1, 1).expand(N, 1, F)).squeeze(1)
                reward = f[:, S]
                done = (f[:, S + 1] > 0.5) | (t + 1 >= max_steps)
                oh = torch.where(done[:, None], reset_row[None, :], f[:, :S].to(dtype))
                t = torch.where(done, torch.zeros_like(t), t + 1)
                acc = acc + reward.sum()
            return acc

        bench(carry_run, f"carry     N={N} (dtype={str(dtype).split('.')[-1]})",
              n_iter=5, steps_per_call=N * T)
        _, ref = mxu.run_random_reduced(mxu.reset(), _gen(1), T)
        got = carry_run()
        equal = torch.equal(got.cpu(), ref["reward_sum"].cpu())
        log(f"  carry vs construct reward totals equal: {equal} "
            f"({float(got)} vs {float(ref['reward_sum'])})")
        ROWS.append({"check": f"carry N={N} reward totals equal", "equal": equal})
        if not equal:
            raise SystemExit(f"engine-carry N={N}: reward totals differ")


# --------------------------------------------------------------------------
# engine-pallas, engine-stoch
# --------------------------------------------------------------------------
def _lane_totals(vec, state, actions, draws=None):
    """The compiled engine stepped through ``actions`` (and a stochastic
    env's ``draws``), with per-lane accumulators as the kernels keep them:
    the final ``(idx, t, ep_return, ep_hidden, ep_len)`` and the
    ``reward``, ``episode`` and ``finished_return`` sums of each lane."""
    n = vec.n_envs
    racc = torch.zeros(n, dtype=torch.float32, device=DEVICE)
    eacc = torch.zeros(n, dtype=torch.int32, device=DEVICE)
    facc = torch.zeros(n, dtype=torch.float32, device=DEVICE)
    for s in range(actions.shape[0]):
        state, out = vec.step(state, actions[s],
                              None if draws is None else tuple(d[s] for d in draws))
        done = out["done"]
        racc += out["reward"]
        eacc += done.to(torch.int32)
        facc += torch.where(done, out["finished_return"], torch.zeros_like(facc))
    return (state.idx, state.t, state.ep_return, state.ep_hidden, state.ep_len,
            racc, eacc, facc)


def _engine_pair(label_a, label_b, vec, ker, T, ker_reset, draw, run_streams):
    """Time both engines' ``run_random_reduced`` from fresh states on the
    same generator state; then check them on the same draws (``draw(g)``:
    the kernel engine's ``[T, N]`` streams, made as its
    ``run_random_reduced`` makes them): every lane's final state and its
    reward, episode and finished-return sums bitwise, and so the totals,
    summed in float64 (a float32 total past 2^24 depends on the order of
    its additions, which the two engines do not share)."""
    N = vec.n_envs
    st0 = vec.reset(_gen(0))
    bench(lambda: vec.run_random_reduced(st0, _gen(1), T), f"{label_a} N={N}",
          n_iter=5, steps_per_call=N * T)
    ks0 = ker_reset()
    bench(lambda: ker.run_random_reduced(ks0, _gen(1), T), f"{label_b} N={N}",
          n_iter=5, steps_per_call=N * T)
    streams = draw(_gen(1))
    a = _lane_totals(vec, vec.reset(_gen(0)), streams[0], streams[1:] or None)
    b = tuple(x.reshape(-1) for x in run_streams(ker_reset(), *streams))
    equal = all(torch.equal(x.to(torch.float64), y.to(torch.float64)) for x, y in zip(a, b))
    tot = {k: [float(x[i].to(torch.float64).sum()) for x in (a, b)]
           for i, k in ((5, "reward_sum"), (6, "episodes"), (7, "finished_return_sum"))}
    log(f"  lanes and totals equal: {equal}  (engine, kernel) {tot}")
    ROWS.append({"check": f"{label_b.strip()} N={N} lanes and totals equal to the compiled "
                 "engine", "equal": equal, "totals": tot})
    if not equal:
        raise SystemExit(f"{label_b.strip()} N={N}: lanes or totals differ from the "
                         "compiled engine")


def engine_pallas(args):
    from ..envs import make_env
    from ..envs.vec import VecEnv
    from ..ops.rollout_kernel import RolloutEngine

    cenv = make_env("shift", compiled=True, device=DEVICE)
    T = _size(args.t, 16384, 256)
    for N in _size(args.lanes, [4096], [64]):
        ker = RolloutEngine(cenv, N)
        _engine_pair("xla-mxu", "pallas ", VecEnv(cenv, N), ker, T, ker.reset,
                     lambda g: (torch.randint(0, ker.A, (T, N), dtype=torch.int32,
                                              generator=g, device=DEVICE),),
                     ker.run_actions)


def engine_stoch(args):
    from ..envs import make_env
    from ..envs.vec import VecEnv
    from ..ops.stoch_rollout_kernel import StochRolloutEngine

    T = _size(args.t, 16384, 128)
    for alias in args.aliases:
        kw = {"cap": 15} if alias in ("friend", "foe", "neutral") else {}
        cenv = make_env(alias, compiled=True, device=DEVICE, **kw)
        for N in _size(args.lanes, [4096], [64]):
            ker = StochRolloutEngine(cenv, N)
            _engine_pair(f"{alias} xla-mxu", f"{alias} kernel ", VecEnv(cenv, N), ker, T,
                         lambda: ker.reset(_gen(0)), lambda g: ker.draw_streams(g, T),
                         ker.run_streams)


# --------------------------------------------------------------------------
# ppo-kernel-opt
# --------------------------------------------------------------------------
def ppo_kernel_opt(args):
    """The optimize phase alone: B6 (``FusedPPOTrainer.optimize_fast``)
    against ``MXUPPOTrainer.optimize_fast`` on one flat rollout with the
    same tile permutations; the two results are held to B6's tolerances."""
    from ..agents.ppo import PPOAgent, ravel
    from ..envs import make_env
    from ..envs.vec import VecEnv
    from ..training import FusedPPOTrainer, MXUPPOTrainer

    N, T = _size(args.n_envs, 4096, 32), _size(args.t, 64, 16)
    env = make_env("island", compiled=True, device=DEVICE)
    B = N * T
    flat = _random_flat(env, B, 3)
    results = {}
    for cls, label in ((MXUPPOTrainer, "xla fast optimize"),
                       (FusedPPOTrainer, "fused kernel optimize")):
        agent = PPOAgent(env, net="table")
        tr = cls(agent, VecEnv(env, N))
        astate, _ = tr.init(seed=0, generator=_gen(0))
        perms = tr.draw_perms(_gen(1), B)
        ce = torch.tensor(0.01, dtype=torch.float32, device=DEVICE)
        n_upd = agent.epochs * agent.n_minibatches
        bench(lambda: tr.optimize_fast(astate, flat, perms, B, entropy_coef=ce),
              f"{label} ({n_upd} updates)", n_iter=6)
        results[label] = tr.optimize_fast(astate, flat, perms, B, entropy_coef=ce)
    (p0, _, _, _, l0), (p1, _, _, _, l1) = results.values()
    err = float((ravel(p0) - ravel(p1)).abs().max())
    ok = torch.allclose(ravel(p1), ravel(p0), rtol=2e-4, atol=2e-6) and torch.allclose(
        l1, l0, rtol=2e-5, atol=1e-6)
    log(f"  B6 against the autograd optimize: params max abs err {err:.3g}, "
        f"loss {float(l1):.6g} vs {float(l0):.6g}, within B6's tolerances: {ok}")
    ROWS.append({"check": "B6 params/loss within rtol 2e-4 / atol 2e-6 and 2e-5 / 1e-6",
                 "equal": ok, "max_abs_err": err})
    if not ok:
        raise SystemExit("ppo-kernel-opt: B6 parts from the autograd optimize")


def main(argv=None) -> list:
    global DEVICE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", type=str, default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", type=str, default=None, help="write the rows as JSON")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def parser(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--platform", type=str, default=argparse.SUPPRESS)
        p.add_argument("--out", type=str, default=argparse.SUPPRESS)
        p.set_defaults(fn=fn)
        return p

    # Sizes default to the reference's on the card (diag.py:738-790) and to
    # a toy size on the CPU (None below).
    p = parser("ppo-decomp", ppo_decomp)
    p.add_argument("--n-envs", type=int, default=None)   # 4096
    p.add_argument("--t", type=int, default=None)        # 64

    p = parser("ppo-candidates", ppo_candidates)
    p.add_argument("--n-envs", type=int, default=None)   # 4096

    p = parser("ppo-e2e", ppo_e2e)
    p.add_argument("--n-envs", type=int, default=None)   # 4096

    p = parser("ppo-lanes", ppo_lanes)
    p.add_argument("--t", type=int, default=None)        # 64
    p.add_argument("--k", type=int, default=None)        # 8
    p.add_argument("--lanes", type=int, nargs="*", default=None)  # 4096 ... 32768

    p = parser("dqn-decomp", dqn_decomp)
    p.add_argument("--n-envs", type=int, default=None)   # 4096
    p.add_argument("--t", type=int, default=None)        # 256

    p = parser("engine-carry", engine_carry)
    p.add_argument("--t", type=int, default=None)        # 1024
    p.add_argument("--lanes", type=int, nargs="*", default=None)  # 4096 65536

    p = parser("engine-pallas", engine_pallas)
    p.add_argument("--t", type=int, default=None)        # 16384
    p.add_argument("--lanes", type=int, nargs="*", default=None)  # 4096

    p = parser("ppo-kernel-opt", ppo_kernel_opt)
    p.add_argument("--n-envs", type=int, default=None)   # 4096
    p.add_argument("--t", type=int, default=None)        # 64

    p = parser("engine-stoch", engine_stoch)
    p.add_argument("--t", type=int, default=None)        # 16384
    p.add_argument("--lanes", type=int, nargs="*", default=None)  # 4096
    p.add_argument("--aliases", type=str, nargs="*",
                   default=["absent", "interrupt", "whisky", "friend", "tomato"])

    args = ap.parse_args(argv)
    DEVICE = platform_device(args.platform)
    ROWS.clear()
    if DEVICE.type == "cpu":
        log("platform cpu: toy sizes unless given; host wall-clock times, "
            "no time here is a device time")
    else:
        from .learner_cases import nvidia_smi

        log(f"card: {nvidia_smi('name,power.limit')}")
    args.fn(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"cmd": args.cmd, "device": str(DEVICE), "rows": ROWS}, f, indent=1)
    return list(ROWS)


if __name__ == "__main__":
    main()
