"""Parity, reproducibility and A/B timing of the two learner kernels, B4
(``dqn_update``) and B6 (``ppo_optimize``), in one process on one card.

    python -m safe_grid_agents_torch.tools.ab_learners \\
        [--parent _archive/parent] [--rounds 4] [--no-check] [--out ab_learners.json]

Check (unless ``--no-check``): every case of ``learner_cases`` (B4:
sokoban, whisky, ragged on a cluster of 8, wide and ragged_wide on 16; B6:
island, absent, ragged) is launched twice and the two results must be
bitwise equal, must meet the plain version's tolerances, and the wrapper's
Python mirror of the launch geometry must equal the built kernel's.

A/B (with ``--parent``): the package under ``--parent`` (the parent
commit's tree, unpacked with ``git archive`` into the git-ignored
``_archive/``) is imported beside this one and both wrappers, each with its
own kernel build, are timed at the main path's shapes (B4 sokoban, whisky,
wide; B6 island, absent) in rounds of parent, new, new, parent: one
CUDA-event-timed call each after one warm-up call each. Prints a line per
case and one JSON object with every time and the card's name and power
limit (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dqn_update_kernel as duk
from ..ops import ppo_kernel as pk
from . import learner_cases as lc

# B4 case -> the cluster size its shape needs (so both sizes are run).
B4_CHECKS = {"sokoban": 8, "whisky": 8, "wide": 16, "ragged": 8, "ragged_wide": 16}
B6_CHECKS = ("island", "absent", "ragged")
B4_TIMED = ("sokoban", "whisky", "wide")
B6_TIMED = ("island", "absent")


def log(*a):
    print(*a, flush=True)


def b4_shape(agent, args):
    D = agent.obs_flat.shape[1]
    H1, H2 = agent.hidden
    U, B = args[-1].action.shape
    return D, H1, H2, int(args[0]["w3"].shape[1]), U, B


def check_b4_case(name: str, dev, g) -> float:
    """One B4 case: the geometry mirror against the built kernel's, two
    launches bitwise equal, the plain version's tolerances; returns the
    largest error."""
    agent, args = lc.dqn_case(name, dev, g)
    D, H1, H2, A, U, B = b4_shape(agent, args)
    geo = duk.geometry(D, H1, H2, A, B)
    built = duk.kernel_geometry(D, H1, H2, A, B)
    if built != (geo.cluster, geo.row_tile, geo.smem_bytes):
        raise AssertionError(f"B4 {name}: geometry mirror {geo} != kernel {built}")
    if geo.cluster != B4_CHECKS[name]:
        raise AssertionError(f"B4 {name}: cluster of {geo.cluster}, expected {B4_CHECKS[name]}")
    first = duk.dqn_update(agent, *args)
    second = duk.dqn_update(agent, *args)
    torch.cuda.synchronize()
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B4 {name} cluster {geo.cluster}: two launches differ")
    err = lc.check_b4(first, duk.dqn_update_reference(agent, *args))
    log(f"B4 {name:11s} U={U} B={B} D={D} hidden {H1}x{H2} cluster {geo.cluster} row tile "
        f"{geo.row_tile} ({geo.smem_bytes} B shared a block): two launches bitwise equal; "
        f"max |err| {err:.3g} vs plain (rtol 2e-4, atol 1e-6; loss rtol 2e-5)")
    return err


def check_b6_case(name: str, dev, g) -> float:
    """One B6 case, checked as ``check_b4_case`` does."""
    agent, args = lc.ppo_case(name, dev, g)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S, D = agent.obs_flat.shape
    H1, H2 = agent.hidden
    P, (U, B) = args[0].numel(), args[-1][0].shape
    geo = pk.geometry(S, D, H1, H2, agent.env.n_actions, P, B, n_sm)
    built = pk.kernel_geometry(S, D, H1, H2, agent.env.n_actions, P, B, n_sm)
    mirror = (geo.tiles, geo.tiles_per_block, geo.grid, int(geo.gf_in_smem), geo.smem_bytes,
              geo.scratch_floats)
    if built != mirror:
        raise AssertionError(f"B6 {name}: geometry mirror {mirror} != kernel {built}")
    first = pk.ppo_optimize(agent, *args)
    second = pk.ppo_optimize(agent, *args)
    torch.cuda.synchronize()
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B6 {name}: two launches differ")
    err = lc.check_b6(first, pk.ppo_optimize_reference(agent, *args))
    log(f"B6 {name:7s} U={U} B={B} S={S} D={D}: {geo.tiles} tiles, stripes of "
        f"{geo.tiles_per_block} over {geo.grid} blocks ({geo.smem_bytes} B shared): two "
        f"launches bitwise equal; max |err| {err:.3g} vs plain")
    return err


def check(dev, g) -> dict:
    """Every case of ``B4_CHECKS`` and ``B6_CHECKS``; returns the errors."""
    out = {f"b4 {name}": check_b4_case(name, dev, g) for name in B4_CHECKS}
    out.update({f"b6 {name}": check_b6_case(name, dev, g) for name in B6_CHECKS})
    return out


def ab_time(dev, g, parent_alias: str, rounds: int) -> dict:
    """Median CUDA-event ms of the parent's and this package's wrappers at
    the main path's shapes, in rounds of parent, new, new, parent."""
    p_duk, p_pk = lc.variant_ops(parent_alias)
    cases = {}
    for name in B4_TIMED:
        agent, args = lc.dqn_case(name, dev, g)
        cases[f"b4 {name}"] = {
            "parent": lambda a=agent, x=args: p_duk.dqn_update(a, *x),
            "new": lambda a=agent, x=args: duk.dqn_update(a, *x)}
    for name in B6_TIMED:
        agent, args = lc.ppo_case(name, dev, g)
        cases[f"b6 {name}"] = {
            "parent": lambda a=agent, x=args: p_pk.ppo_optimize(a, *x),
            "new": lambda a=agent, x=args: pk.ppo_optimize(a, *x)}
    result = {}
    for case, calls in cases.items():
        for fn in calls.values():  # warm-up (and build) each
            fn()
        torch.cuda.synchronize()
        times = {"parent": [], "new": []}
        for _ in range(rounds):
            for label in ("parent", "new", "new", "parent"):
                times[label].append(lc.event_ms(calls[label])[0])
        med = {k: statistics.median(v) for k, v in times.items()}
        result[case] = {"ms": times, "median_ms": med,
                        "speedup": med["parent"] / med["new"]}
        log(f"{case:12s}: parent median {med['parent']:.4f} ms [{min(times['parent']):.4f} … "
            f"{max(times['parent']):.4f}]; new median {med['new']:.4f} ms "
            f"[{min(times['new']):.4f} … {max(times['new']):.4f}]; "
            f"×{result[case]['speedup']:.2f}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None,
                   help="root holding the parent's safe_grid_agents_torch package")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_learners: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit")}
    log(f"card {result['card']}")
    _build.build("dqn_update_kernel", "ppo_kernel")
    for name in ("dqn_update_kernel", "ppo_kernel"):
        log(f"-- {name}: {_build.build_logs.get(name, '(built earlier)').rstrip()}")
    g = torch.Generator(device=dev).manual_seed(0)
    if not args.no_check:
        result["check"] = check(dev, g)
    if args.parent:
        lc.load_package(args.parent, "sga_parent")
        result["ab"] = ab_time(dev, g, "sga_parent", args.rounds)
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
