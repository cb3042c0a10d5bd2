"""Card against CPU on the whisky deep-q command with the same random
streams: is the difference of their finals RNG spread or a fault?

    python -m safe_grid_agents_torch.tools.whisky_streams \\
        [--seeds 6] [--parent _archive/parent] [--out whisky_streams.json]

For each seed s the whisky deep-q command of ``chip_smoke.py`` (``--seed
s``) runs through the CLI's ``run``:

* ``cpu``: on the CPU (its generator is a CPU ``torch.Generator``);
* ``card, cpu streams``: on the card with every draw (the collect's
  ``rand_a`` and ``u``, the mechanics draws, the update's ``[U, B]``
  indices, resets and eval draws) made by a CPU ``torch.Generator`` seeded
  s, in the same order as the CPU run, and moved to the card; with the
  package's B4 and, given ``--parent``, with the parent's;
* ``card``: on the card with the card's own generator, as the CLI runs it.

Then, for each seed, the CPU and card trainers run chunk by chunk in
lockstep on the same CPU streams; the first chunk whose lanes part (their
state indices differ) is reported with the largest parameter difference
and the number of greedy-row entries that differ just before it: B9 and
the CPU's plain collect are bitwise equal on equal inputs, so lanes part
only where a greedy action differs, i.e. where B4's rounding (within its
tolerance) has moved an argmax. Prints one JSON object (also written to
``--out``) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import torch

from ..agents import make_agent
from ..cli import main as cli
from ..cli.parsing import agent_kwargs, prepare_parser
from ..envs import make_env
from ..envs.vec import VecEnv
from ..training import FusedDQNTrainer
from ..training import dqn_fused
from . import learner_cases as lc

_DRAWS = ("rand", "randint", "randn", "randperm")


@contextlib.contextmanager
def cpu_streams():
    """Inside: a draw with a CPU generator for a CUDA device is made on the
    CPU and moved to the card; ``torch.Generator(device=...)`` makes a CPU
    generator."""
    real = {name: getattr(torch, name) for name in _DRAWS}
    real_gen = torch.Generator

    def wrap(fn):
        def draw(*a, generator=None, device=None, **kw):
            if (generator is not None and generator.device.type == "cpu"
                    and device is not None and torch.device(device).type == "cuda"):
                return fn(*a, generator=generator, device="cpu", **kw).to(device)
            return fn(*a, generator=generator, device=device, **kw)
        return draw

    try:
        for name, fn in real.items():
            setattr(torch, name, wrap(fn))
        torch.Generator = lambda device=None: real_gen()
        yield
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)
        torch.Generator = real_gen


@contextlib.contextmanager
def b4_from(fn):
    """Inside: the fused DQN trainer launches ``fn`` as its update."""
    real = dqn_fused.dqn_update
    dqn_fused.dqn_update = fn
    try:
        yield
    finally:
        dqn_fused.dqn_update = real


def final(stats: dict) -> dict:
    return {k: float(stats[k]) for k in ("mean_return", "mean_hidden")}


def lockstep(seed: int, dev) -> dict:
    """The CPU and card trainers chunk by chunk on the same CPU streams."""
    args = prepare_parser().parse_args(lc.DQN_WHISKY + ["--seed", str(seed)])
    trainers, states, gens = [], [], []
    for d in (torch.device("cpu"), dev):
        env = make_env(args.env, compiled=True, device=d)
        agent = make_agent(args.agent, env, **agent_kwargs(args))
        tr = FusedDQNTrainer(agent, VecEnv(env, args.n_envs),
                             updates_per_chunk=args.updates_per_chunk)
        g = torch.Generator().manual_seed(seed)
        with cpu_streams():
            a, v = tr.init(seed=seed, generator=g)
            a, v, _ = tr.warmup_chunk(a, v, g, args.warmup_steps)
        trainers.append(tr)
        states.append([a, v])
        gens.append(g)
    n_chunks = max(1, args.steps // (args.chunk_steps * args.n_envs))
    out = {"chunks": n_chunks, "first_parting_chunk": None}
    for i in range(n_chunks):
        greedy = [tr.greedy_row(st[0].params).cpu() for tr, st in zip(trainers, states)]
        pdiff = max(float((states[0][0].params[k] - states[1][0].params[k].cpu()).abs().max())
                    for k in states[0][0].params)
        with cpu_streams():
            for tr, st, g in zip(trainers, states, gens):
                a, v, _, _ = tr.train_chunk(st[0], st[1], g, args.chunk_steps)
                st[:] = [a, v]
        same = torch.equal(states[0][1][0], states[1][1][0].cpu())
        if not same and out["first_parting_chunk"] is None:
            out.update(first_parting_chunk=i, max_param_diff_before=pdiff,
                       greedy_entries_differing=int((greedy[0] != greedy[1]).sum()))
    out["max_param_diff_end"] = max(
        float((states[0][0].params[k] - states[1][0].params[k].cpu()).abs().max())
        for k in states[0][0].params)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--parent", default=None,
                   help="root holding the parent's safe_grid_agents_torch package")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("whisky_streams: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit"), "seeds": {}}
    print(f"card {result['card']}", flush=True)
    parent_update = None
    if args.parent:
        lc.load_package(args.parent, "sga_parent")
        parent_update = lc.variant_ops("sga_parent")[0].dqn_update
    for seed in range(args.seeds):
        argv_s = lc.DQN_WHISKY + ["--seed", str(seed)]
        row = {"cpu": final(cli.run(argv_s + ["--platform", "cpu"]))}
        with cpu_streams():
            row["card, cpu streams"] = final(cli.run(argv_s))
            if parent_update is not None:
                with b4_from(parent_update):
                    row["card, cpu streams, parent B4"] = final(cli.run(argv_s))
        row["card"] = final(cli.run(argv_s))
        row["lockstep"] = lockstep(seed, dev)
        result["seeds"][seed] = row
        print(f"seed {seed}: " + "; ".join(
            f"{k} {v['mean_return']:.4f} / {v['mean_hidden']:.4f}"
            for k, v in row.items() if k != "lockstep") + f"; lockstep {row['lockstep']}",
            flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
