"""Cases of the data-parallel runtime, run by its tests and by
``chip_smoke.py`` phase 9: the eight trainer families ``DPTrainer`` wraps,
and the functions each rank runs (``parallel.launch.spawn`` imports them in
fresh processes, so this module imports the port and nothing else).

* ``build_family`` / ``run_family``: a small trainer of each family and
  one chunk of it (DQN after a warmup);
* ``replicated``: every family's chunk at W ranks, the replicated leaves
  returned for the caller to compare across ranks;
* ``twins``: the reference's DP tests (``tests/test_dp.py``) at W ranks;
* ``sites``: each collective site on handed-over inputs (the caller holds
  the result against the JAX function under ``shard_map``);
* ``sharded``: the sharded B1 and B7 engines on handed-over streams, their
  outputs made whole, and the reduced protocol's totals.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..agents.crmdp import PPOCRMDPAgent
from ..agents.dqn import DQNAgent
from ..agents.ppo import PPOAgent
from ..agents.tabular import TabularQAgent, TabularQState
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..envs.compiled import TableState
from ..envs.vec import VecEnv
from ..ops import rollout_kernel as rk
from ..ops import stoch_rollout_kernel as srk
from ..parallel.dp import DPTrainer, rank_seed
from ..parallel.mesh import make_mesh
from ..training import (
    CRMDPTrainer, DQNTrainer, MXUCRMDPTrainer, MXUDQNTrainer, MXUPPOTrainer,
    MXUTabularQTrainer, PPOTrainer, TabularQTrainer, stats_to_host, whiten,
)
from ..utils.checkpoint import leaves

FAMILIES = ("tabular", "tabular-mxu", "dqn", "dqn-mxu", "ppo", "ppo-mxu", "crmdp",
            "crmdp-mxu")
N_ENVS = 16   # global lanes of a family case
T_CHUNK = 16  # steps of its chunk


def build_family(name: str, device, n_envs: int = N_ENVS):
    """A trainer of family ``name`` over ``n_envs`` global lanes on ``device``."""
    mxu = name.endswith("-mxu")
    base = name.removesuffix("-mxu")
    alias = {"tabular": "shift", "dqn": "sokoban", "ppo": "island", "crmdp": "corners"}[base]
    env = make_env(alias, compiled=True, device=device) if mxu else make_env(alias)
    vec = VecEnv(env, n_envs) if mxu else ArrayVecEnv(env, n_envs, device)
    if base == "tabular":
        agent = TabularQAgent(env, lr=0.2, epsilon_anneal_steps=2000)
        return (MXUTabularQTrainer if mxu else TabularQTrainer)(agent, vec)
    if base == "dqn":
        kw = dict(table=True, n_step=3) if mxu else dict(prioritized=True, double_q=True)
        agent = DQNAgent(env, batch_size=32, replay_capacity=512, sync_every=3,
                         hidden=(32, 32), **kw)
        return (MXUDQNTrainer if mxu else DQNTrainer)(agent, vec, updates_per_chunk=4)
    net = dict(net="table") if mxu else {}
    kw = dict(hidden=(32, 32), epochs=2, n_minibatches=2, lr=1e-3, **net)
    if base == "ppo":
        return (MXUPPOTrainer if mxu else PPOTrainer)(PPOAgent(env, **kw), vec)
    return (MXUCRMDPTrainer if mxu else CRMDPTrainer)(PPOCRMDPAgent(env, crmdp_lr=1.0, **kw),
                                                       vec)


def run_family(trainer, generator: torch.Generator, seed: int = 0,
               n_steps: int = T_CHUNK):
    """``init``, a DQN warmup, then one chunk: ``(astate, vstate, stats,
    loss or None)``."""
    astate, vstate = trainer.init(seed=seed, generator=generator)
    if getattr(trainer, "has_warmup", hasattr(trainer, "warmup_chunk")):
        astate, vstate, _ = trainer.warmup_chunk(astate, vstate, generator, n_steps)
    out = trainer.train_chunk(astate, vstate, generator, n_steps)
    return out[0], out[1], out[2], (out[3] if len(out) > 3 else None)


def cpu_leaves(tree, skip=()) -> Dict[str, torch.Tensor]:
    """``{path: CPU tensor}`` of ``tree``'s tensor leaves, paths under any
    of the prefixes ``skip`` left out."""
    out = {}
    for path, x in leaves(tree):
        key = "/".join(path)
        if isinstance(x, torch.Tensor) and not any(key.startswith(p) for p in skip):
            out[key] = x.detach().cpu().clone()
    return out


def family_chunk(name: str, group, seed: int = 0):
    """Rank-side: family ``name`` wrapped in ``DPTrainer`` over ``group``,
    one chunk from the rank's generator; the leaves every rank must hold
    alike (the learner state but each rank's own replay ring, the summed
    stats, the loss)."""
    tr = DPTrainer(build_family(name, group.device), group)
    g = torch.Generator(device=group.device).manual_seed(rank_seed(seed, group.rank))
    astate, vstate, stats, loss = run_family(tr, g, seed)
    out = cpu_leaves(astate, skip=("buffer/storage", "buffer/priorities"))
    out.update({f"stats/{k}": v for k, v in cpu_leaves(stats).items()})
    if loss is not None:
        out["loss"] = loss.detach().cpu()
    out["lanes"] = torch.tensor(tr.vec.n_envs)
    return out


def replicated(names=FAMILIES):
    """Rank-side: ``family_chunk`` of each family."""
    group = make_mesh()
    return {name: family_chunk(name, group) for name in names}


def twins():
    """Rank-side twins of ``tests/test_dp.py`` (shift tabular learning, the
    PPO and CRMDP chunks, the DQN ring sizes, PER's per-rank priorities) on
    the CPU; returns their numbers."""
    group = make_mesh()
    W, dev = group.world_size, group.device
    out = {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(rank_seed(seed, group.rank))

    shift = make_env("shift")
    tr = DPTrainer(TabularQTrainer(TabularQAgent(shift, lr=0.2, epsilon_anneal_steps=20_000),
                                   ArrayVecEnv(shift, 64, dev)), group)
    g = gen(1)
    astate, vstate = tr.init(seed=0, generator=g)
    for _ in range(10):
        astate, vstate, _ = tr.train_chunk(astate, vstate, g, 128)
    _, es = tr.eval_chunk(astate, tr.reset_envs(g), 30, generator=g)
    out["tabular_eval"] = stats_to_host(es)
    out["tabular_q_sum"] = float(astate.q.double().sum())

    tr = DPTrainer(PPOTrainer(PPOAgent(shift), ArrayVecEnv(shift, 64, dev)), group)
    g = gen(1)
    astate, vstate = tr.init(seed=0, generator=g)
    _, _, stats, loss = tr.train_chunk(astate, vstate, g, 16)
    out["ppo"] = {"loss": float(loss), **stats_to_host(stats)}

    sokoban = make_env("sokoban")
    for per in (False, True):
        agent = DQNAgent(sokoban, replay_capacity=4096, batch_size=64, prioritized=per,
                         double_q=per)
        tr = DPTrainer(DQNTrainer(agent, ArrayVecEnv(sokoban, 64, dev), updates_per_chunk=4),
                       group)
        g = gen(1)
        astate, vstate = tr.init(seed=0, generator=g)
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 16)
        rec = {"capacity": int(tr.trainer.agent.replay_capacity),
               "size": int(astate.buffer.size)}
        if per:
            rec["priorities_warmup"] = astate.buffer.priorities.cpu().clone()
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 16)
        rec["loss"] = float(loss)
        if per:
            rec["priorities_train"] = astate.buffer.priorities.cpu().clone()
        out["dqn_per" if per else "dqn"] = rec

    corners = make_env("corners")
    tr = DPTrainer(CRMDPTrainer(PPOCRMDPAgent(corners), ArrayVecEnv(corners, 64, dev)), group)
    g = gen(1)
    astate, vstate = tr.init(seed=0, generator=g)
    astate, _, _, loss = tr.train_chunk(astate, vstate, g, 16)
    out["crmdp"] = {"loss": float(loss), "corruption": astate.corruption.cpu().clone()}
    out["world"] = W
    return out


# ---- the collective sites -------------------------------------------------------------

def sites(cases: dict):
    """Rank-side: each collective site on rank ``r``'s share of the handed
    over inputs (``cases[site]["ranks"][r]``, numpy), with ``group``."""
    group = make_mesh()
    r = group.rank
    out = {}

    c = cases["tabular"]
    env = make_env("shift")
    agent = TabularQAgent(env, lr=c["lr"])
    mine = {k: torch.from_numpy(v) for k, v in c["ranks"][r].items()}
    st = agent.learn(TabularQState(q=torch.from_numpy(c["q"]),
                                   step=torch.tensor(c["step"], dtype=torch.int64)),
                     mine["s_idx"], mine["actions"], mine["rewards"], mine["next_idx"],
                     mine["dones"], group=group)
    out["tabular"] = {"q": st.q, "step": st.step}

    c = cases["dqn"]
    cenv = make_env("sokoban", compiled=True, device="cpu")
    agent = DQNAgent(cenv, **c["agent"])
    astate = convert.dqn_state_from_jax(*c["state"], buffer=c["ranks"][r]["ring"], table=True,
                                        device="cpu")
    losses = []
    for slots in c["ranks"][r]["slots"]:
        astate, loss = agent.update(astate, slots=torch.from_numpy(slots), group=group)
        losses.append(loss)
    out["dqn"] = {"params": astate.params, "target": astate.target_params, "mu": astate.mu,
                  "nu": astate.nu, "loss": torch.stack(losses)}

    c = cases["whiten"]
    out["whiten"] = whiten(torch.from_numpy(c["ranks"][r]), group)

    c = cases["ppo"]
    cenv = make_env("island", compiled=True, device="cpu")
    agent = PPOAgent(cenv, **c["agent"])
    tree, count, mu, nu, step = c["state"]
    astate = convert.ppo_state_from_jax(tree, count, mu, nu, step, "cpu")
    tr = MXUPPOTrainer(agent, VecEnv(cenv, 8))
    b = c["ranks"][r]
    idx = torch.from_numpy(b["idx"])
    flat = {"states": TableState(idx=idx, t=torch.zeros_like(idx)),
            **{k: torch.from_numpy(b[k]) for k in ("actions", "old_logp", "advantages",
                                                   "returns")}}
    p, mu, nu, count, loss = tr.optimize_fast(astate, flat, torch.from_numpy(b["perms"]),
                                              len(b["idx"]), torch.tensor(c["coef"]), group)
    out["ppo"] = {"params": p, "mu": mu, "nu": nu, "count": count, "loss": loss}

    c = cases["crmdp"]
    cenv = make_env("corners", compiled=True, device="cpu")
    agent = PPOCRMDPAgent(cenv, net="table", crmdp_lr=c["lr"])
    b = {k: torch.from_numpy(v) for k, v in c["ranks"][r].items()}
    out["crmdp"] = agent.update_corruption(torch.from_numpy(c["corruption"]), b["next_idx"],
                                           b["observed"], b["hidden"], group)
    return out


# ---- the sharded engines -------------------------------------------------------------

def sharded(cases: dict, seed: int = 21):
    """Rank-side: the sharded B1 on ``cases["b1"]`` (``alias``, global
    ``state`` and ``actions``, numpy) and B7 on each of ``cases["b7"]``
    (``alias``, global ``state``, the four global streams), their outputs
    made whole; then each engine's reduced protocol from a generator seeded
    ``seed`` (alike on every rank) and B7's reset from one seeded ``seed``."""
    group = make_mesh()
    dev = group.device
    out = {"b1": {}, "b7": {}, "totals": {}, "reset": {}}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for c in cases["b1"]:
        eng = rk.ShardedRolloutEngine(make_env(c["alias"], compiled=True, device=dev),
                                      c["n"], group)
        state = tuple(eng.shard(t(x)) for x in c["state"])
        outs = eng.gather(eng.run_actions(state, t(c["actions"])))
        out["b1"][c["alias"]] = [x.cpu() for x in outs]
        g = torch.Generator(device=dev).manual_seed(seed)
        _, acc = eng.run_random_reduced(eng.reset(), g, c["actions"].shape[0])
        out["totals"][c["alias"]] = {k: v.cpu() for k, v in acc.items()}
    for c in cases["b7"]:
        eng = srk.ShardedStochRolloutEngine(make_env(c["alias"], compiled=True, device=dev),
                                            c["n"], group)
        state = tuple(eng.shard(t(x)) for x in c["state"])
        outs = eng.gather(eng.run_streams(state, *(t(x) for x in c["streams"])))
        out["b7"][c["alias"]] = [x.cpu() for x in outs]
        g = torch.Generator(device=dev).manual_seed(seed)
        reset = eng.reset(g)
        out["reset"][c["alias"]] = [x.cpu() for x in eng.gather(reset)]
        _, acc = eng.run_random_reduced(reset, g, c["streams"][0].shape[0])
        out["totals"][c["alias"]] = {k: v.cpu() for k, v in acc.items()}
    out["rank"] = group.rank
    return out


def single_engine_totals(alias: str, n: int, n_steps: int, seed: int = 21,
                         device="cpu") -> Optional[dict]:
    """The single engine's reduced protocol on a generator seeded ``seed``
    (B7: the reset first), for ``sharded``'s totals to be held against."""
    cenv = make_env(alias, compiled=True, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    if VecEnv(cenv, n).stochastic:
        eng = srk.StochRolloutEngine(cenv, n)
        reset = eng.reset(g)
        _, acc = eng.run_random_reduced(reset, g, n_steps)
        return {"reset": list(reset), "totals": acc}
    eng = rk.RolloutEngine(cenv, n)
    _, acc = eng.run_random_reduced(eng.reset(), g, n_steps)
    return {"totals": acc}


def one_rank_diff(name: str, group, seed: int = 3):
    """Family ``name`` over ``group.device``: one chunk unwrapped and one
    wrapped in ``DPTrainer`` over ``group`` (world size 1), each from a
    generator seeded ``seed``; returns the paths of the leaves that differ
    (none: the wrapper at W = 1 is bitwise the trainer)."""
    dev = group.device
    want = cpu_leaves(run_family(build_family(name, dev),
                                 torch.Generator(device=dev).manual_seed(seed)))
    got = cpu_leaves(run_family(DPTrainer(build_family(name, dev), group),
                                torch.Generator(device=dev).manual_seed(seed)))
    if sorted(got) != sorted(want):
        return sorted(set(got) ^ set(want))
    return [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]


CARD_B7 = ("absent", "whisky", "tomato", "friend")


def max_abs_err(got, want) -> float:
    """The largest ``|got - want|`` over paired tensors of any dtype."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))


def sharded_card(n: int, t1: int, t7: int, seed: int = 9, device="cuda"):
    """Rank-side on the card (``chip_smoke.py`` phase 9): the sharded B1 on
    shift and the sharded B7 on ``CARD_B7`` at ``n`` global lanes over the
    group (NCCL at world size 1, or gloo ranks sharing one card).

    First the main path: each engine's reduced protocol (B1 ``t1`` steps,
    B7 ``t7``) from a generator seeded ``seed``, the kernels' launch counts
    set to 0 just before and read just after. Then the checks, from the
    same seeds: each engine's per-lane outputs, made whole, against the
    single engine's and the plain version's (on rank 0), and the totals
    against the single engine's reduced protocol."""
    dev = torch.device(device)
    group = make_mesh(device=dev)
    engines = {"shift": rk.ShardedRolloutEngine(make_env("shift", compiled=True, device=dev),
                                                n, group)}
    for alias in CARD_B7:
        engines[alias] = srk.ShardedStochRolloutEngine(
            make_env(alias, compiled=True, device=dev), n, group)

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    def reduced(eng, alias, g):
        if alias == "shift":
            return eng.run_random_reduced(eng.reset(), g, t1)[1]
        return eng.run_random_reduced(eng.reset(g), g, t7)[1]

    counts = (rk.counts, rk.global_counts, srk.counts)
    for c in counts:
        c.reset()
    totals = {alias: reduced(eng, alias, gen()) for alias, eng in engines.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {"rollout": rk.counts.launches + rk.global_counts.launches,
                "stoch_rollout": srk.counts.launches,
                "plain": sum(c.plain_calls for c in counts)}

    checks = {}
    for alias, eng in engines.items():
        g = gen()
        if alias == "shift":
            full = rk.reset_state(n, eng.reset_idx, dev)
            actions = torch.randint(0, eng.A, (t1, n), dtype=torch.int32, generator=g,
                                    device=dev)
            outs = eng.gather(eng.run_actions(eng.reset(), actions))
            single = (lambda: rk.rollout(eng.engine.tables, full, actions),
                      lambda: rk.rollout_reference(eng.engine.tables, full, actions))
            one = rk.RolloutEngine(eng.cenv, n)
        else:
            full = eng.wide.reset(g)
            streams = eng.draw_streams(g, t7)
            outs = eng.gather(eng.run_streams(tuple(eng.shard(x) for x in full), *streams))
            single = (lambda: srk.stoch_rollout(eng.wide.tables, full, *streams),
                      lambda: srk.stoch_rollout_reference(eng.wide.tables, full, *streams))
            one = eng.wide
        rec = {"lanes_equal_single": None, "lanes_equal_plain": None}
        if group.rank == 0:
            for key, fn in zip(list(rec), single):
                ref = fn()
                rec[key] = all(torch.equal(a, b) for a, b in zip(outs, ref))
            rec["max_abs_err"] = max_abs_err(outs, ref)  # against the plain version
            g = gen()
            want = (one.run_random_reduced(one.reset(), g, t1)[1] if alias == "shift"
                    else one.run_random_reduced(one.reset(g), g, t7)[1])
            got = totals[alias]
            rec["episodes_equal"] = bool(torch.equal(got["episodes"], want["episodes"]))
            rec["float_totals_bitwise"] = all(
                bool(torch.equal(got[k], want[k])) for k in ("reward_sum", "finished_return_sum"))
            rec["float_totals_rel_err"] = max(
                abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1.0)
                for k in ("reward_sum", "finished_return_sum"))
        rec["totals"] = {k: float(v) for k, v in totals[alias].items()}
        checks[alias] = rec
    return {"rank": group.rank, "world": group.world_size, "launches": launches,
            "checks": checks}
