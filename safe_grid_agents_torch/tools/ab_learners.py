"""Parity, reproducibility and A/B timing of the learner kernels, B4
(``dqn_update``) and B6 (``ppo_optimize``), and A/B timing of the
stochastic tabular-Q and PPO collect kernels, B8 (``tabq_stoch``) and B10
(``ppo_stoch_collect``), in one process on one card.

    python -m safe_grid_agents_torch.tools.ab_learners \\
        [--parent _archive/parent] [--cases b8,b10] [--rounds 4] [--no-check] \\
        [--out ab_learners.json]

Check (unless ``--no-check``): every case of ``learner_cases`` (B4:
sokoban, whisky, ragged on a cluster of 8, wide and ragged_wide on 16,
hidden512 and batch4096 on the one-block route; B6: island, absent, ragged
on the persistent route, island256 on the wide route) is launched twice and
the two results must be bitwise equal, must meet the plain version's
tolerances, and the wrapper's Python mirror of the route's launch geometry
must equal the built kernel's.

A/B (with ``--parent``): the package under ``--parent`` (the parent
commit's tree, unpacked with ``git archive`` into the git-ignored
``_archive/``) is imported beside this one and both wrappers, each with its
own kernel build, are timed at the main path's shapes in rounds of parent,
new, new, parent: one CUDA-event-timed call each after one warm-up call
each, every B8/B10 result held bitwise equal between the two. ``--cases``
picks the kernels: ``b4`` (sokoban, whisky, wide), ``b6`` (island,
absent), ``b8`` (``learner_cases.B8_CASES``: absent, tomato and whisky at
the CLI shape and at N = 4096, T = 8192, and tomato's hot-cell start) and
``b10`` (``B10_CASES``: absent at N = 1024, T = 32 and four aliases at
N = 4096, T = 1024); cases of at most 128 steps also get each variant's
device time (CUDA events behind a spin kernel, ``learner_cases.fenced_ms``)
and the host time of the wrapper's launch path (calls issued back to
back). Prints a line per case and one JSON
object with every time and the card's name and power limit (also written
to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dqn_update_kernel as duk
from ..ops import ppo_kernel as pk
from ..ops import ppo_stoch_collect_kernel as psk
from ..ops import tabular_stoch_kernel as tsk
from . import learner_cases as lc

# B4 case -> the cluster size its shape needs (so both sizes are run); the
# cases of the one-block route; B6's cases of the persistent and wide routes.
B4_CHECKS = {"sokoban": 8, "whisky": 8, "wide": 16, "ragged": 8, "ragged_wide": 16}
B4_BLOCK_CHECKS = ("hidden512", "batch4096")
B6_CHECKS = ("island", "absent", "ragged")
B6_WIDE_CHECKS = ("island256",)
# The restored routes' cases are checked at U = 4 (their kernels take
# seconds at the full U).
CHECK_UPDATES = {"hidden512": 4, "batch4096": 4, "island256": 4}
B4_TIMED = ("sokoban", "whisky", "wide")
B6_TIMED = ("island", "absent")
AB_KERNELS = ("b4", "b6", "b8", "b10")


def log(*a):
    print(*a, flush=True)


def b4_shape(agent, args):
    D = agent.obs_flat.shape[1]
    H1, H2 = agent.hidden
    U, B = args[-1].action.shape
    return D, H1, H2, int(args[0]["w3"].shape[1]), U, B


def check_b4_case(name: str, dev, g) -> float:
    """One B4 case: the route and its geometry mirror against the built
    kernel's, two launches bitwise equal, the plain version's tolerances;
    returns the largest error."""
    agent, args = lc.dqn_case(name, dev, g, updates=CHECK_UPDATES.get(name))
    D, H1, H2, A, U, B = b4_shape(agent, args)
    want = B4_CHECKS.get(name, "block")
    route = duk.route(D, H1, H2, A, B)
    if route != ("block" if want == "block" else "cluster"):
        raise AssertionError(f"B4 {name}: route {route}, expected {want}")
    if route == "cluster":
        geo = duk.geometry(D, H1, H2, A, B)
        built = duk.kernel_geometry(D, H1, H2, A, B)
        if built != (geo.cluster, geo.row_tile, geo.smem_bytes):
            raise AssertionError(f"B4 {name}: geometry mirror {geo} != kernel {built}")
        if geo.cluster != want:
            raise AssertionError(f"B4 {name}: cluster of {geo.cluster}, expected {want}")
        where = (f"cluster {geo.cluster} row tile {geo.row_tile} ({geo.smem_bytes} B shared "
                 "a block)")
    else:
        lay = duk.block_layout(B, H1, H2, A)
        built = duk.kernel_block_layout(B, H1, H2, A)
        if built != lay:
            raise AssertionError(f"B4 {name}: block layout mirror {lay} != kernel {built}")
        where = f"one block, placement {lay[0]} ({lay[1]} B shared, {lay[2]} scratch floats)"
    counts = duk.counts if route == "cluster" else duk.block_counts
    launches = counts.launches
    first = duk.dqn_update(agent, *args)
    second = duk.dqn_update(agent, *args)
    torch.cuda.synchronize()
    if counts.launches != launches + 2:
        raise AssertionError(f"B4 {name}: the {route} route did not launch twice")
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B4 {name} {route}: two launches differ")
    err = lc.check_b4(first, duk.dqn_update_reference(agent, *args))
    log(f"B4 {name:11s} U={U} B={B} D={D} hidden {H1}x{H2} {where}: two launches bitwise "
        f"equal; max |err| {err:.3g} vs plain (rtol 2e-4, atol 1e-6; loss rtol 2e-5)")
    return err


def check_b6_case(name: str, dev, g) -> float:
    """One B6 case, checked as ``check_b4_case`` does."""
    agent, args = lc.ppo_case(name, dev, g, updates=CHECK_UPDATES.get(name))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S, D = agent.obs_flat.shape
    H1, H2 = agent.hidden
    A = agent.env.n_actions
    P, (U, B) = args[0].numel(), args[-1][0].shape
    route = pk.route(S, D, H1, H2, A)
    want = "wide" if name in B6_WIDE_CHECKS else "persistent"
    if route != want:
        raise AssertionError(f"B6 {name}: route {route}, expected {want}")
    if route == "persistent":
        geo = pk.geometry(S, D, H1, H2, A, P, B, n_sm)
        built = pk.kernel_geometry(S, D, H1, H2, A, P, B, n_sm)
        mirror = (geo.tiles, geo.tiles_per_block, geo.grid, int(geo.gf_in_smem),
                  geo.smem_bytes, geo.scratch_floats)
        where = (f"{geo.tiles} tiles, stripes of {geo.tiles_per_block} over {geo.grid} "
                 f"blocks ({geo.smem_bytes} B shared)")
    else:
        geo = pk.wide_geometry(S, D, H1, H2, A, P, B)
        built = pk.kernel_wide_geometry(S, D, H1, H2, A, P, B)
        mirror = (geo.rows, geo.blocks, int(geo.gf_in_smem), geo.smem_bytes,
                  geo.scratch_floats)
        where = (f"wide route: {geo.blocks} blocks of {geo.rows} rows ({geo.smem_bytes} B "
                 "shared)")
    if built != mirror:
        raise AssertionError(f"B6 {name}: geometry mirror {mirror} != kernel {built}")
    counts = pk.counts if route == "persistent" else pk.wide_counts
    launches = counts.launches
    first = pk.ppo_optimize(agent, *args)
    second = pk.ppo_optimize(agent, *args)
    torch.cuda.synchronize()
    if counts.launches != launches + 2:
        raise AssertionError(f"B6 {name}: the {route} route did not launch twice")
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B6 {name}: two launches differ")
    err = lc.check_b6(first, pk.ppo_optimize_reference(agent, *args))
    log(f"B6 {name:9s} U={U} B={B} S={S} D={D} hidden {H1}x{H2}: {where}: two launches "
        f"bitwise equal; max |err| {err:.3g} vs plain")
    return err


def check(dev, g) -> dict:
    """Every case of both routes of B4 and B6; returns the errors."""
    out = {f"b4 {name}": check_b4_case(name, dev, g)
           for name in (*B4_CHECKS, *B4_BLOCK_CHECKS)}
    out.update({f"b6 {name}": check_b6_case(name, dev, g)
                for name in (*B6_CHECKS, *B6_WIDE_CHECKS)})
    return out


def host_us(call, n: int = 200) -> float:
    """Host µs per call of ``call`` issued back to back without a sync: the
    wrapper's launch path, where the device time per call is shorter."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / n


def _ab_cases(dev, g, parent_alias: str, kernels) -> dict:
    """``case -> ({"parent": call, "new": call}, bitwise, small)``: whether
    the two outputs must be equal, and whether the case takes at most 128
    steps (then its device time and launch path are timed too)."""
    cases = {}
    if "b4" in kernels or "b6" in kernels:
        p_duk, p_pk = lc.variant_ops(parent_alias)
    for name in B4_TIMED if "b4" in kernels else ():
        agent, args = lc.dqn_case(name, dev, g)
        cases[f"b4 {name}"] = ({"parent": lambda a=agent, x=args: p_duk.dqn_update(a, *x),
                                "new": lambda a=agent, x=args: duk.dqn_update(a, *x)},
                               False, False)
    for name in B6_TIMED if "b6" in kernels else ():
        agent, args = lc.ppo_case(name, dev, g)
        cases[f"b6 {name}"] = ({"parent": lambda a=agent, x=args: p_pk.ppo_optimize(a, *x),
                                "new": lambda a=agent, x=args: pk.ppo_optimize(a, *x)},
                               False, False)
    if "b8" in kernels or "b10" in kernels:
        p_tsk, p_psk = lc.variant_stoch_ops(parent_alias)
    b8 = [(name, False) for name in lc.B8_CASES] + [("tomato wide", True)]
    for name, hot in b8 if "b8" in kernels else ():
        args = lc.tabq_stoch_case(name, dev, g, hot=hot)
        cases[f"b8 {name}{' hot' if hot else ''}"] = (
            {"parent": lambda x=args: p_tsk.tabq_stoch(*x),
             "new": lambda x=args: tsk.tabq_stoch(*x)}, True, args[5].shape[0] <= 128)
    for name in lc.B10_CASES if "b10" in kernels else ():
        args = lc.ppo_stoch_case(name, dev, g)
        cases[f"b10 {name}"] = (
            {"parent": lambda x=args: p_psk.ppo_stoch_collect(*x),
             "new": lambda x=args: psk.ppo_stoch_collect(*x)}, True, args[3].shape[0] <= 128)
    return cases


def ab_time(dev, g, parent_alias: str, rounds: int, kernels=("b4", "b6")) -> dict:
    """Median CUDA-event ms of the parent's and this package's wrappers at
    the main path's shapes of ``kernels``, in rounds of parent, new, new,
    parent; B8/B10 outputs held bitwise equal between the two, and for the
    cases of at most 128 steps each one's device ms (``lc.fenced_ms``) and
    host µs of its launch path (``host_us``)."""
    result = {}
    for case, (calls, bitwise, small) in _ab_cases(dev, g, parent_alias, kernels).items():
        outs = {label: fn() for label, fn in calls.items()}  # warm-up (and build) each
        torch.cuda.synchronize()
        if bitwise and not lc.outputs_equal(outs["parent"], outs["new"]):
            raise AssertionError(f"{case}: the parent's and the new kernel's outputs differ")
        del outs
        times = {"parent": [], "new": []}
        for _ in range(rounds):
            for label in ("parent", "new", "new", "parent"):
                times[label].append(lc.event_ms(calls[label])[0])
        med = {k: statistics.median(v) for k, v in times.items()}
        result[case] = {"ms": times, "median_ms": med,
                        "speedup": med["parent"] / med["new"]}
        extra = ""
        if small:
            dev_ms = {label: lc.fenced_ms(fn) for label, fn in calls.items()}
            host = {label: host_us(fn) for label, fn in calls.items()}
            result[case]["device_ms"], result[case]["host_us"] = dev_ms, host
            extra = (f"; device (fenced events) parent {dev_ms['parent']:.4f} ms, new "
                     f"{dev_ms['new']:.4f} ms; host launch path parent {host['parent']:.1f} µs, "
                     f"new {host['new']:.1f} µs")
        log(f"{case:20s}: parent median {med['parent']:.4f} ms [{min(times['parent']):.4f} … "
            f"{max(times['parent']):.4f}]; new median {med['new']:.4f} ms "
            f"[{min(times['new']):.4f} … {max(times['new']):.4f}]; "
            f"×{result[case]['speedup']:.2f}{' (outputs equal)' if bitwise else ''}{extra}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", default=None,
                   help="root holding the parent's safe_grid_agents_torch package")
    p.add_argument("--cases", default="b4,b6",
                   help=f"comma-separated kernels to A/B, of {','.join(AB_KERNELS)}")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_learners: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    result = {"card": lc.nvidia_smi("name,power.limit")}
    log(f"card {result['card']}")
    sources = ("dqn_update_kernel", "dqn_update_block", "ppo_kernel", "ppo_wide_kernel",
               "tabular_stoch_kernel", "ppo_stoch_collect_kernel")
    _build.build(*sources)
    for name in sources:
        log(f"-- {name}: {_build.build_logs.get(name, '(built earlier)').rstrip()}")
    g = torch.Generator(device=dev).manual_seed(0)
    if not args.no_check:
        result["check"] = check(dev, g)
    if args.parent:
        lc.load_package(args.parent, "sga_parent")
        kernels = tuple(k for k in args.cases.split(",") if k)
        if not set(kernels) <= set(AB_KERNELS):
            raise SystemExit(f"--cases: pick from {AB_KERNELS}")
        result["ab"] = ab_time(dev, g, "sga_parent", args.rounds, kernels)
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
