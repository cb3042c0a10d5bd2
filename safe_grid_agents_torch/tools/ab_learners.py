"""Parity, reproducibility and A/B timing of the learner kernels, B4
(``dqn_update``) and B6 (``ppo_optimize``), and A/B timing of the tabular-Q
kernels B2 (``tabq``) and B8 (``tabq_stoch``), of the stochastic PPO and
DQN collects B10 (``ppo_stoch_collect``) and B9 (``dqn_stoch_collect``), of
the DQN and PPO collects B3 (``dqn_collect``) and B5 (``ppo_collect``) and
of the actor-critic forward B11 (``fused_mlp_forward``), in one process on
one card.

    python -m safe_grid_agents_torch.tools.ab_learners \\
        [--parent _archive/parent] [--cases b5,b11] [--rounds 4] [--no-check] \\
        [--out ab_learners.json]

Check (unless ``--no-check``): every case of ``learner_cases`` (B4:
sokoban, whisky, ragged on a cluster of 8, wide and ragged_wide on 16,
hidden512, batch4096, ragged_grid and sync_grid on the grid route; B6:
island, absent, ragged on the persistent route, island256, ragged256,
actions8 and wide1813 on the wide route) is launched twice and the two
results must be bitwise equal, must meet the plain version's tolerances,
only the intended route's launch count may move, and the wrapper's Python
mirror of the route's launch geometry must equal the built kernel's. B4's
``wide`` case is also checked update by update
(``learner_cases.check_b4_per_update``: each of its 256 updates from the
plain version's state, held to rtol 2e-4 / atol 1e-6), on its own draw and
on the draw on which its end-to-end check parts
(``learner_cases.b4_wide_shared_draw``), where the end-to-end result's
entries beyond the tolerance are counted and printed.

A/B (with ``--parent``): the package under ``--parent`` (the parent
commit's tree, unpacked with ``git archive`` into the git-ignored
``_archive/``) is imported beside this one and both wrappers, each with its
own kernel build, are timed at the main path's shapes in rounds of parent,
new, new, parent: one CUDA-event-timed call each after one warm-up call
each, every B3/B5/B8/B9/B10 result held bitwise equal between the two, every
B2 result held to its own package's plain version (the new one bitwise,
the parent's float sums with Q within atol 1e-4 and the rest equal), and
every B11 result within atol 1e-5 of the plain version. ``--cases`` picks the
kernels: ``b2`` (``learner_cases.B2_CASES``: the shift preset's N = 64,
T = 128 and N = 4096, T = 8192, and the hot-cell start at full width),
``b4`` (sokoban, whisky, wide on the cluster route; hidden512 and
batch4096 on the grid route), ``b6`` (island, absent on the persistent
route; island256 on the wide route), ``b8``
(``learner_cases.B8_CASES``: absent, tomato and whisky at the CLI shape and
at N = 4096, T = 8192, and tomato's hot-cell start), ``b10``
(``B10_CASES``: absent at N = 1024, T = 32 and four aliases at N = 4096,
T = 1024), ``b9`` (``B9_CASES``: the whisky deep-q command's N = 128,
T = 32 and four aliases at N = 4096, T = 4096), ``b3`` (``B3_CASES``: the
sokoban DQN command's N = 128, T = 32 and N = 4096, T = 4096), ``b5`` (``B5_CASES``: the island preset's
N = 1024, T = 64, sokoban at N = 4096, T = 1024, and N = 33, T = 17) and
``b11`` (``B11_CASES``: 1024 and 16,384 rows); cases of at most 128 steps, and
B11's, also get each variant's device time (CUDA events behind a spin
kernel, ``learner_cases.fenced_ms``) and the host time of the wrapper's
launch path (calls issued back to back). Prints a line per case and one JSON
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
from ..ops import dqn_kernel as dk
from ..ops import dqn_stoch_kernel as dsk
from ..ops import dqn_update_kernel as duk
from ..ops import fused_mlp as fm
from ..ops import ppo_collect_kernel as pck
from ..ops import ppo_kernel as pk
from ..ops import ppo_stoch_collect_kernel as psk
from ..ops import tabular_kernel as tk
from ..ops import tabular_stoch_kernel as tsk
from . import learner_cases as lc

# B4 case -> the cluster size its shape needs (so both sizes are run); the
# cases of the grid route; B6's cases of the persistent and wide routes.
B4_CHECKS = {"sokoban": 8, "whisky": 8, "wide": 16, "ragged": 8, "ragged_wide": 16}
B4_GRID_CHECKS = ("hidden512", "batch4096", "ragged_grid", "sync_grid")
B6_CHECKS = ("island", "absent", "ragged")
B6_WIDE_CHECKS = ("island256", "ragged256", "actions8", "wide1813")
B4_TIMED = ("sokoban", "whisky", "wide", "hidden512", "batch4096")
B6_TIMED = ("island", "absent", "island256")
AB_KERNELS = ("b2", "b3", "b4", "b6", "b8", "b9", "b10", "b5", "b11")
# B4's cases checked update by update: the wide case's own draw, and the
# draw on which its end-to-end check parts.
B4_PER_UPDATE = ("wide", "wide_shared_draw")


def log(*a):
    print(*a, flush=True)


def b4_shape(agent, args):
    D = agent.obs_flat.shape[1]
    H1, H2 = agent.hidden
    U, B = args[-1].action.shape
    return D, H1, H2, int(args[0]["w3"].shape[1]), U, B


def check_b4_case(name: str, dev, g) -> float:
    """One B4 case: the route and its geometry mirror against the built
    kernel's, two launches bitwise equal and only the route's launch count
    moved, the plain version's tolerances; returns the largest error."""
    agent, args = lc.dqn_case(name, dev, g)
    D, H1, H2, A, U, B = b4_shape(agent, args)
    want = B4_CHECKS.get(name, "grid")
    route = duk.route(D, H1, H2, A, B)
    if route != ("grid" if want == "grid" else "cluster"):
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
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        geo = duk.grid_geometry(D, H1, H2, A, B, agent.double_q, n_sm)
        built = duk.kernel_grid_geometry(D, H1, H2, A, B, agent.double_q, n_sm)
        if built != geo.report():
            raise AssertionError(f"B4 {name}: grid mirror {geo.report()} != kernel {built}")
        where = (f"grid of {geo.grid} blocks, {sum(j.items for p in geo.phases for j in p)} "
                 f"tiles an update ({geo.scratch_floats} scratch floats)")
    counts, other = ((duk.counts, duk.grid_counts) if route == "cluster"
                     else (duk.grid_counts, duk.counts))
    launches, others = counts.launches, other.launches
    first = duk.dqn_update(agent, *args)
    second = duk.dqn_update(agent, *args)
    torch.cuda.synchronize()
    if counts.launches != launches + 2 or other.launches != others:
        raise AssertionError(f"B4 {name}: the {route} route did not launch twice alone")
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B4 {name} {route}: two launches differ")
    err = lc.check_b4(first, duk.dqn_update_reference(agent, *args))
    log(f"B4 {name:11s} U={U} B={B} D={D} hidden {H1}x{H2} {where}: two launches bitwise "
        f"equal; max |err| {err:.3g} vs plain (rtol 2e-4, atol 1e-6; loss rtol 2e-5)")
    return err


def check_b6_case(name: str, dev, g) -> float:
    """One B6 case, checked as ``check_b4_case`` does."""
    agent, args = lc.ppo_case(name, dev, g)
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
        geo = pk.wide_geometry(S, D, H1, H2, A, P, B, n_sm)
        built = pk.kernel_wide_geometry(S, D, H1, H2, A, P, B, n_sm)
        mirror = geo.report()
        where = (f"wide route: grid of {geo.grid} blocks, {sum(j.items for j in geo.jobs)} "
                 f"tiles an update ({geo.scratch_floats} scratch floats)")
    if built != mirror:
        raise AssertionError(f"B6 {name}: geometry mirror {mirror} != kernel {built}")
    counts, other = ((pk.counts, pk.wide_counts) if route == "persistent"
                     else (pk.wide_counts, pk.counts))
    launches, others = counts.launches, other.launches
    first = pk.ppo_optimize(agent, *args)
    second = pk.ppo_optimize(agent, *args)
    torch.cuda.synchronize()
    if counts.launches != launches + 2 or other.launches != others:
        raise AssertionError(f"B6 {name}: the {route} route did not launch twice alone")
    if not lc.outputs_equal(first, second):
        raise AssertionError(f"B6 {name}: two launches differ")
    err = lc.check_b6(first, pk.ppo_optimize_reference(agent, *args))
    log(f"B6 {name:9s} U={U} B={B} S={S} D={D} hidden {H1}x{H2}: {where}: two launches "
        f"bitwise equal; max |err| {err:.3g} vs plain")
    return err


def check_b4_per_update_case(name: str, dev, g) -> dict:
    """One of ``B4_PER_UPDATE``: every update held to the plain version's
    from the plain version's state; on the shared draw, the end-to-end
    result's entries beyond the tolerance are counted too."""
    if name == "wide_shared_draw":
        agent, args = lc.b4_wide_shared_draw(dev)
    else:
        agent, args = lc.dqn_case(name, dev, g)
    result = lc.check_b4_per_update(agent, args)
    note = ""
    if name == "wide_shared_draw":
        beyond = lc.b4_beyond(duk.dqn_update(agent, *args), duk.dqn_update_reference(agent, *args))
        result["end_to_end_beyond"] = beyond
        note = "; end to end, entries beyond rtol 2e-4 / atol 1e-6: " + ", ".join(
            f"{k} {n} of {m} (max |diff| {d:.3g})" for k, (n, m, d) in beyond.items() if n)
    log(f"B4 {name} per update: {result['updates']} updates each within rtol 2e-4 / atol 1e-6 "
        f"of the plain version from its state; max |err| {result['max_abs_err']:.3g}{note}")
    return result


def check(dev, g) -> dict:
    """Every case of both routes of B4 and B6, and B4's per-update cases;
    returns the errors."""
    out = {f"b4 {name}": check_b4_case(name, dev, g)
           for name in (*B4_CHECKS, *B4_GRID_CHECKS)}
    out.update({f"b4 {name} per update": check_b4_per_update_case(name, dev, g)
                for name in B4_PER_UPDATE})
    out.update({f"b6 {name}": check_b6_case(name, dev, g)
                for name in (*B6_CHECKS, *B6_WIDE_CHECKS)})
    return out


def fresh_wide1813(dev, parent_alias: str) -> dict:
    """B6's ``wide1813`` case from a fresh optimizer (the card leg starts
    one plain update in): parameters beyond the plain tolerance, and the
    largest difference, of the plain version on the CPU (on the same
    inputs), the parent's kernel and this package's, each against the
    plain version on the card."""
    def over(got, want):
        d = (got.to(want.device) - want).abs()
        return int((d > 2e-6 + 2e-4 * want.abs()).sum()), float(d.max())

    agent, args = lc.ppo_case("wide1813", dev, torch.Generator(device=dev).manual_seed(0),
                              fresh=True)
    ref = pk.ppo_optimize_reference(agent, *args)[0]
    cpu = torch.device("cpu")
    cpu_agent = lc.ppo_case("wide1813", cpu, torch.Generator().manual_seed(0), updates=1,
                            fresh=True)[0]
    cpu_args = tuple(x.cpu() if torch.is_tensor(x) else tuple(t.cpu() for t in x)
                     for x in args)
    _, p_pk = lc.variant_ops(parent_alias)
    result = {"plain on the CPU": over(pk.ppo_optimize_reference(cpu_agent, *cpu_args)[0], ref),
              "parent": over(p_pk.ppo_optimize(agent, *args)[0], ref),
              "new": over(pk.ppo_optimize(agent, *args)[0], ref)}
    log("B6 wide1813 from a fresh optimizer, against the plain version on the card "
        "(parameters beyond rtol 2e-4 / atol 2e-6, largest |difference|): " + "; ".join(
            f"{k} {n}, {m:.3g}" for k, (n, m) in result.items()))
    return result


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


def _bitwise(case: str):
    def check(outs):
        if not lc.outputs_equal(outs["parent"], outs["new"]):
            raise AssertionError(f"{case}: the parent's and the new kernel's outputs differ")
        return "outputs equal"
    return check


def _within_plain(case: str, args):
    def check(outs):
        ref = fm.fused_mlp_reference(*args)
        err = {}
        for label, got in outs.items():
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0.0, atol=1e-5,
                                           msg=lambda m: f"{case} {label}: {m}")
            err[label] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        return (f"within atol 1e-5 of plain (max |err| parent {err['parent']:.3g}, new "
                f"{err['new']:.3g})")
    return check


def _own_plain(case: str, args, parent_tk):
    """B2's check: the new kernel bitwise equal to this package's plain
    version (both sum the TD errors in exact fixed point); the parent's, whose
    float atomics sum in a run-dependent order, to its own package's plain
    version with the reference's Q tolerance (atol 1e-4, every other output
    equal). The two kernels are not held to each other: over a long chunk
    from a hot reset their sums part trajectories (cells whose Q should tie
    come apart by an ulp and an argmax flips)."""
    def check(outs):
        ref = tk.tabq_reference(*args)
        if not lc.outputs_equal(outs["new"], ref):
            raise AssertionError(f"{case}: the new kernel differs from the plain version")
        p_ref = parent_tk.tabq_reference(*args)
        p = outs["parent"]
        torch.testing.assert_close(p[0], p_ref[0], rtol=0.0, atol=1e-4,
                                   msg=lambda m: f"{case}: Q parent vs its plain version: {m}")
        if not lc.outputs_equal(p[1:], p_ref[1:]):
            raise AssertionError(f"{case}: the parent's kernel differs from its plain version")
        return (f"new bitwise equal to the plain version; parent's Q within atol 1e-4 of its "
                f"plain version ({float((p[0] - p_ref[0]).abs().max()):.3g}), the rest equal")
    return check


def _ab_cases(dev, g, parent_alias: str, kernels) -> dict:
    """``case -> ({"parent": call, "new": call}, check, small)``: ``check``
    holds the two warm-up outputs (raising if they disagree) and returns a
    note, or is None; ``small`` says whether the case's device time and
    launch path are timed too (at most 128 steps, and B11)."""
    cases = {}
    if "b4" in kernels or "b6" in kernels:
        p_duk, p_pk = lc.variant_ops(parent_alias)
    for name in B4_TIMED if "b4" in kernels else ():
        agent, args = lc.dqn_case(name, dev, g)
        cases[f"b4 {name}"] = ({"parent": lambda a=agent, x=args: p_duk.dqn_update(a, *x),
                                "new": lambda a=agent, x=args: duk.dqn_update(a, *x)},
                               None, False)
    for name in B6_TIMED if "b6" in kernels else ():
        agent, args = lc.ppo_case(name, dev, g)
        cases[f"b6 {name}"] = ({"parent": lambda a=agent, x=args: p_pk.ppo_optimize(a, *x),
                                "new": lambda a=agent, x=args: pk.ppo_optimize(a, *x)},
                               None, False)
    if "b8" in kernels or "b10" in kernels:
        p_tsk, p_psk = lc.variant_stoch_ops(parent_alias)
    b8 = [(name, False) for name in lc.B8_CASES] + [("tomato wide", True)]
    for name, hot in b8 if "b8" in kernels else ():
        args = lc.tabq_stoch_case(name, dev, g, hot=hot)
        case = f"b8 {name}{' hot' if hot else ''}"
        cases[case] = ({"parent": lambda x=args: p_tsk.tabq_stoch(*x),
                        "new": lambda x=args: tsk.tabq_stoch(*x)},
                       _bitwise(case), args[5].shape[0] <= 128)
    for name in lc.B10_CASES if "b10" in kernels else ():
        args = lc.ppo_stoch_case(name, dev, g)
        case = f"b10 {name}"
        cases[case] = ({"parent": lambda x=args: p_psk.ppo_stoch_collect(*x),
                        "new": lambda x=args: psk.ppo_stoch_collect(*x)},
                       _bitwise(case), args[3].shape[0] <= 128)
    if "b9" in kernels:
        p_dsk = lc.variant_module(parent_alias, "dqn_stoch_kernel")
        for name in lc.B9_CASES:
            args = lc.dqn_stoch_collect_case(name, dev, g)
            case = f"b9 {name}"
            cases[case] = ({"parent": lambda x=args: p_dsk.dqn_stoch_collect(*x),
                            "new": lambda x=args: dsk.dqn_stoch_collect(*x)},
                           _bitwise(case), args[5].shape[0] <= 128)
    if "b2" in kernels:
        p_tk = lc.variant_module(parent_alias, "tabular_kernel")
        b2 = [(name, False) for name in lc.B2_CASES] + [("shift wide", True)]
        for name, hot in b2:
            args = lc.tabq_case(name, dev, g, hot=hot)
            case = f"b2 {name}{' hot' if hot else ''}"
            cases[case] = ({"parent": lambda x=args: p_tk.tabq(*x),
                            "new": lambda x=args: tk.tabq(*x)},
                           _own_plain(case, args, p_tk), args[5].shape[0] <= 128)
    if "b3" in kernels:
        p_dk = lc.variant_module(parent_alias, "dqn_kernel")
        for name in lc.B3_CASES:
            args = lc.dqn_collect_case(name, dev, g)
            case = f"b3 {name}"
            cases[case] = ({"parent": lambda x=args: p_dk.dqn_collect(*x),
                            "new": lambda x=args: dk.dqn_collect(*x)},
                           _bitwise(case), args[5].shape[0] <= 128)
    if "b5" in kernels:
        p_pck = lc.variant_module(parent_alias, "ppo_collect_kernel")
        for name in lc.B5_CASES:
            args = lc.ppo_collect_case(name, dev, g)
            case = f"b5 {name}"
            cases[case] = ({"parent": lambda x=args: p_pck.ppo_collect(*x),
                            "new": lambda x=args: pck.ppo_collect(*x)},
                           _bitwise(case), args[3].shape[0] <= 128)
    if "b11" in kernels:
        p_fm = lc.variant_module(parent_alias, "fused_mlp")
        for name, B in lc.B11_CASES.items():
            args = lc.fused_mlp_case(B, dev, g)
            case = f"b11 {name}"
            cases[case] = ({"parent": lambda x=args: p_fm.fused_mlp_forward(*x),
                            "new": lambda x=args: fm.fused_mlp_forward(*x)},
                           _within_plain(case, args), True)
    return cases


def ab_time(dev, g, parent_alias: str, rounds: int, kernels=("b4", "b6")) -> dict:
    """Median CUDA-event ms of the parent's and this package's wrappers at
    the main path's shapes of ``kernels``, in rounds of parent, new, new,
    parent; B3/B5/B8/B9/B10 outputs held bitwise equal between the two, B2's
    each held to its own package's plain version (``_own_plain``), B11's
    within atol 1e-5 of the plain version, and for the cases of at most 128
    steps and B11's each one's device ms (``lc.fenced_ms``) and host µs of
    its launch path (``host_us``)."""
    result = {}
    for case, (calls, check, small) in _ab_cases(dev, g, parent_alias, kernels).items():
        outs = {label: fn() for label, fn in calls.items()}  # warm-up (and build) each
        torch.cuda.synchronize()
        note = check(outs) if check is not None else ""
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
            f"×{result[case]['speedup']:.2f}{f' ({note})' if note else ''}{extra}")
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
    sources = ("tabular_kernel", "dqn_kernel", "dqn_update_kernel", "dqn_update_grid",
               "ppo_kernel", "ppo_wide_kernel", "tabular_stoch_kernel",
               "ppo_stoch_collect_kernel", "ppo_collect_kernel", "fused_mlp",
               "dqn_stoch_kernel")
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
        if "b6" in kernels:
            result["fresh_wide1813"] = fresh_wide1813(dev, "sga_parent")
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
