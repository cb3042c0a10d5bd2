"""B1, B2, B3 and B5 with their tables in device memory, held against their
plain versions on the card; the cases ``chip_smoke.py`` phase 3l runs and
the shapes phase 5 times.

Each case is launched twice (the two launches bitwise equal) and held
bitwise against the plain version (B2's Q within the reference's atol 1e-4,
and in fact bitwise: its TD sums are exact). The device-memory placement
runs on conveyor (7,056 states) and, for B1, on sokoban2 (175,616); the
shared-memory placement, whose instantiation this slice leaves as it was,
runs on toy, boat and corners for B1 and B2. Every wrapper's placement and
shared-memory mirrors are held against the built kernel's. Run alone:

    python -m safe_grid_agents_torch.tools.placement_cases
"""
from __future__ import annotations

import json
import sys

import torch

from ..agents.dqn import DQNAgent
from ..agents.ppo import PPOAgent
from ..envs import make_env
from ..envs.vec import VecEnv
from ..ops import dqn_kernel as dk
from ..ops import ppo_collect_kernel as pck
from ..ops import rollout_kernel as rk
from ..ops import tabular_kernel as tk
from ..training import FusedDQNTrainer, FusedPPOTrainer
from . import learner_cases as lc

# (alias, N, T): from reset and from mid-episode each. Partial warps and
# tiles (33, 17) and no steps (T = 0) on every device-memory case.
B1_CASES = (("conveyor", 4096, 1024), ("conveyor", 33, 17), ("conveyor", 33, 0),
            ("conveyor-sushi", 4096, 256), ("sokoban2", 4096, 1024), ("sokoban2", 33, 17),
            ("toy", 4096, 1024), ("toy", 33, 17), ("boat", 4096, 1024), ("corners", 33, 17))
# (alias, N, T, start) of tabq_edge_case: hot (every lane on the reset
# state), random Q and lanes, lanes near the time limit.
B2_CASES = (("conveyor", 128, 128, "hot"), ("conveyor", 128, 128, "random"),
            ("conveyor", 33, 17, "timeout"), ("conveyor", 33, 0, "random"),
            ("conveyor", 4096, 64, "hot"), ("conveyor-sushi", 64, 128, "random"),
            ("toy", 256, 128, "hot"), ("boat", 256, 128, "random"),
            ("corners", 33, 17, "timeout"))
B3_CASES = (("conveyor", 128, 32), ("conveyor", 4096, 256), ("conveyor", 33, 17),
            ("conveyor", 33, 0))
B5_CASES = (("conveyor", 1024, 64), ("conveyor", 33, 17), ("conveyor", 33, 0),
            ("boat", 256, 64))
# Aliases whose placement mirrors are held against the kernels'.
MIRROR_ALIASES = ("shift", "island", "sokoban", "toy", "corners", "boat", "conveyor",
                  "sokoban2")


def _twice(fn, args, label: str):
    outs = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    if not lc.outputs_equal(outs, again):
        raise AssertionError(f"{label}: two launches differ")
    return outs


def _equal(outs, ref, label: str):
    if not lc.outputs_equal(outs, ref):
        bad = [i for i, (a, b) in enumerate(zip(outs, ref)) if not torch.equal(a, b)]
        raise AssertionError(f"{label}: outputs {bad} differ from the plain version's")


def check_b1(dev, g, log=print) -> dict:
    envs, out = {}, {}
    for alias, n, T in B1_CASES:
        if alias not in envs:
            envs[alias] = make_env(alias, compiled=True, device=dev)
        eng = rk.RolloutEngine(envs[alias], n)
        place = rk.placement(*eng.tables.shape)
        for start in ("reset", "mid-episode"):
            state = eng.reset() if start == "reset" else lc.random_lanes(eng.cenv, n, dev, g)
            actions = torch.randint(0, eng.A, (T, n), dtype=torch.int32, generator=g,
                                    device=dev)
            label = f"B1 {alias} ({place}) N={n} T={T} {start}"
            outs = _twice(rk.rollout, (eng.tables, state, actions), label)
            _equal(outs, rk.rollout_reference(eng.tables, state, actions), label)
            log(f"{label}: 8 outputs equal, two launches equal, "
                f"{int(outs[6].sum())} episodes")
        out[alias] = place
    return out


def check_b2(dev, g, log=print) -> float:
    err = 0.0
    for alias, n, T, start in B2_CASES:
        args = lc.tabq_edge_case(alias, n, T, start, dev, g)
        S, A = args[0].shape
        place = tk.placement(S, A, n)
        label = (f"B2 {alias} ({place}, draw tiles of "
                 f"{tk.tile_steps(S, A, n, T, place == 'shared')} steps) N={n} T={T} {start}")
        outs = _twice(tk.tabq, args, label)
        ref = tk.tabq_reference(*args)
        err = max(err, float((outs[0] - ref[0]).abs().max()))
        _equal(outs, ref, label)  # bitwise, inside the reference's Q atol of 1e-4
        log(f"{label}: 11 outputs equal, two launches equal, {int(outs[7].sum())} episodes")
    return err


def dqn_trainer(alias: str, n: int, dev):
    cenv = make_env(alias, compiled=True, device=dev)
    agent = DQNAgent(cenv, lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                     replay_capacity=50_000, sync_every=100)
    return FusedDQNTrainer(agent, VecEnv(cenv, n), updates_per_chunk=32)


def check_b3(dev, g, log=print) -> None:
    for alias, n, T in B3_CASES:
        tr = dqn_trainer(alias, n, dev)
        place = dk.placement(tr.S, tr.A)
        for start in ("reset", "mid-episode"):
            state = tr.init()[1] if start == "reset" else lc.random_lanes(tr.vec.cenv, n, dev, g)
            greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=dev)
            rand_a = torch.randint(0, tr.A, (T, n), dtype=torch.int32, generator=g, device=dev)
            u = torch.rand((T, n), generator=g, device=dev)
            step0 = torch.tensor([20_000], dtype=torch.int64, device=dev)
            for hyper, eps in ((tr.hyper, "annealing"), (tr.hyper.warmup(), "pinned to 1")):
                args = (tr.tables, hyper, greedy, state, step0, rand_a, u)
                label = f"B3 {alias} ({place}) N={n} T={T} {start} ε {eps}"
                outs = _twice(dk.dqn_collect, args, label)
                _equal(outs, dk.dqn_collect_reference(*args), label)
                log(f"{label}: 16 outputs equal, two launches equal, "
                    f"{int(outs[6].sum())} episodes")


def ppo_trainer(alias: str, n: int, dev):
    cenv = make_env(alias, compiled=True, device=dev)
    return FusedPPOTrainer(PPOAgent(cenv, net="table", lr=5e-4), VecEnv(cenv, n))


def check_b5(dev, g, log=print) -> None:
    for alias, n, T in B5_CASES:
        tr = ppo_trainer(alias, n, dev)
        place = pck.placement(tr.S, tr.A)
        astate, vstate = tr.init(seed=3)
        rows = tr.policy_rows(astate.params)
        for start in ("reset", "mid-episode"):
            state = (tuple(x[None] for x in (vstate.idx, vstate.t, vstate.ep_return,
                                             vstate.ep_hidden, vstate.ep_len))
                     if start == "reset" else lc.random_lanes(tr.vec.cenv, n, dev, g))
            u = torch.rand((T, n), generator=g, device=dev)
            label = f"B5 {alias} ({place}) N={n} T={T} {start}"
            outs = _twice(pck.ppo_collect, (tr.tables, rows, state, u), label)
            _equal(outs, pck.ppo_collect_reference(tr.tables, rows, state, u), label)
            log(f"{label}: 18 outputs equal, two launches equal, "
                f"{int(outs[5].sum())} episodes")


def check_mirrors(dev, log=print) -> dict:
    """Every wrapper's placement and shared-memory mirrors against the built
    kernels', per alias; returns ``alias -> {kernel: placement}``."""
    out = {}
    for alias in MIRROR_ALIASES:
        S, A = VecEnv(make_env(alias, compiled=True, device=dev), 1).tables.shape
        got = {}
        for name, mod in (("B1", rk), ("B3", dk), ("B5", pck)):
            place = mod.placement(S, A)
            if mod.kernel_placement(S, A) != place:
                raise AssertionError(f"{name} {alias}: placement mirror {place} differs")
            for staged in (True, False):
                if mod.smem_bytes(S, A, staged) != mod.kernel_smem_bytes(S, A, staged):
                    raise AssertionError(f"{name} {alias}: smem mirror differs ({staged})")
            got[name] = place
        for n, T in ((64, 128), (33, 17), (4096, 8192)):
            place = tk.placement(S, A, n)
            if tk.kernel_placement(S, A, n) != place:
                raise AssertionError(f"B2 {alias} N={n}: placement mirror {place} differs")
            for staged in (True, False):
                mirror = (tk.smem_bytes(S, A, n, T, staged), tk.tile_steps(S, A, n, T, staged))
                if tk.kernel_layout(S, A, n, T, staged) != mirror:
                    raise AssertionError(f"B2 {alias} N={n} T={T}: layout mirror differs")
            got[f"B2 N={n}"] = place
        out[alias] = got
        log(f"placements {alias} (S={S}): {got} (mirrors equal to the kernels')")
    return out


def check_all(dev, g, log=print) -> dict:
    """Every case above; returns the placements and B2's largest Q error."""
    res = {"mirrors": check_mirrors(dev, log)}
    res["b1"] = check_b1(dev, g, log)
    res["b2_q_err"] = check_b2(dev, g, log)
    check_b3(dev, g, log)
    check_b5(dev, g, log)
    return res


def main() -> int:
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    print(json.dumps(check_all(dev, g)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
