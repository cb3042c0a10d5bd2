"""Where the learner kernels (B4, B6) and the stochastic tabular-Q kernel
(B8) spend their time, on one card.

    python -m safe_grid_agents_torch.tools.trace_learners \\
        [--package DIR] [--b4-stamps] [--b6-stamps] [--b8-stamps] [--grid-stamps] \\
        [--launch-split] [--out trace.json]

B6 (``ppo_optimize``): one call at the island preset's 16 updates of 16,384
rows and one at the absent command's 16 of 8192 are traced with
``torch.profiler``; the device time is summed by kernel name (fold, grad,
reduce, gw1, norm, adam in the first design).

B4 (``dqn_update``) is one kernel per call, so the profiler sees no phases.
The kernel sources carry ``SGA_STAMP(i)`` markers at the phase boundaries,
which compile to nothing unless ``SGA_TRACE`` is defined. With
``--b4-stamps`` ``csrc/dqn_update_kernel.cu`` is built with
``-DSGA_TRACE`` (a block barrier and an SM-clock stamp in block 0 of the
cluster at each marker) and launched through the package's wrapper at
sokoban's U=32, B=128 and on the whisky command's MLP: the stamps give each
phase's share of an update.

B6's persistent design is two kernels per update. With ``--b6-stamps``
``csrc/ppo_kernel.cu`` is built with ``-DSGA_TRACE``: block 0 takes
``%globaltimer`` stamps at each phase boundary of its first row tile and at
the end of the grad kernel, and after each grid barrier of the finish
kernel; it runs at island's and absent's shapes.

The grid-wide routes, B4's grid kernel (``csrc/dqn_update_grid.cu``) and
B6's wide kernel (``csrc/ppo_wide_kernel.cu``), are one cooperative launch
a call whose phases are separated by grid barriers. They are timed at the
shapes of the commands that take them (B4 at sokoban's ``--n-hidden 512``
and ``--batch-size 4096``, B6 at island's ``--n-hidden 256``): the
CUDA-event time of a call against its device time by ``torch.profiler``
and by CUDA events behind a spin kernel. With ``--grid-stamps`` both are
built with ``-DSGA_TRACE``: block 0's thread 0 records ``%globaltimer``
after each grid barrier, which splits an update into its phases (barrier
included).

B8 (``tabq_stoch``) is one kernel per chunk whose steps are a serial
chain. With ``--b8-stamps`` ``csrc/tabular_stoch_kernel.cu`` is built with
``-DSGA_TRACE``: thread 0 of its one block records ``clock64()`` at each
marker of every step (no extra barriers), splitting a step into act + env
step, TD aggregation + atomics, the barrier after them, the update of the
touched cells and the barrier after it; it runs at the CLI shape (N = 64,
T = 128) on absent, tomato and whisky, and at N = 4096, T = 8192 on
absent and tomato, from a reset and (tomato) from the hot-cell start.

With ``--launch-split``, B8 at the CLI shape (absent, tomato, whisky), B10
at the absent command's N = 1024, T = 32, B5 at the island preset's
N = 1024, T = 64 and B11 at the MXU PPO trainer's 1024 and 16,384 rows are
split into the device time and the launch path: the CUDA-event time of a
call (host launch path included, as ``chip_smoke.py`` times it), the device
time by ``torch.profiler`` (``kernel_split``) and by CUDA events behind a
spin kernel (``learner_cases.fenced_ms``), and the host µs of the wrapper's
launch path (calls issued back to back). B5's launch path is also split
into its parts (``b5_launch_parts``): the checks, the output allocation,
the device and stream lookup and the ctypes call, each timed alone with
``time.perf_counter_ns`` over 200 calls.

``--package DIR`` traces the package under ``DIR`` (for example the parent
commit's, unpacked with ``git archive`` into ``_archive/``) instead of this
one; the stamps need sources with the markers. Prints one JSON object (also written to ``--out``) with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from . import learner_cases as lc

# The phases between the SGA_STAMP(i) markers of the sources, in marker
# order: stamp i opens phase i, and the last stamp closes the last phase.
# B4: block 0 of the cluster, the online pass's stamps in its last pass.
B4_PHASES = (
    "load the batch",
    "forward: target pass, online pass's x1 slice",
    "online pass: cluster barrier",
    "online pass: x1 gather + layer 2",
    "online pass: head partial + cluster barrier",
    "per-sample (rank sums of the head partials)",
    "head gradients + w3/b3/b2 Adam",
    "gW2 (gathered x1)",
    "dx1 partials + rank sums",
    "w2/b1 Adam",
    "gW1 + w1 Adam",
    "target sync",
)
# B6: block 0 of the grad kernel (the per-tile stamps in its first tile),
# stamps 0-12, then the finish kernel, stamps 16-20.
B6_GRAD_PHASES = (
    "stage W2, heads, biases",
    "load streams",
    "layer 1 (fold gather)",
    "layer 2 (x1·W2)",
    "heads",
    "per-row loss",
    "head sums",
    "dx2",
    "gb2 + gW2 (x1ᵀ·∂x2)",
    "dx1 (∂x2·W2ᵀ)",
    "gb1 + gfold scatter, then the later tiles",
    "write the partial record",
)
B6_FINISH_FIRST = 16
B6_FINISH_PHASES = ("reduce the records", "gw1 + Σg² partials", "norm, clip, Adam", "refold")
# B8: thread 0 of the block, every step.
B8_PHASES = (
    "act + env step",
    "TD aggregation + atomics",
    "barrier after the atomics",
    "update of the touched cells",
    "barrier after the update (+ stream tile wait)",
)
# The grid-wide routes: block 0 after each grid barrier, every update (B6
# wide's refold is not run after the last update).
B4_GRID_PHASES = (
    "layer 1",
    "layer 2",
    "per-sample TD + ∂x2",
    "∂x1 + head and layer-2 gradient parts",
    "layer-1 gradient parts",
    "join + Adam + target sync",
)
B6_WIDE_PHASES = (
    "x1 gather from the fold",
    "layer 2",
    "per-row heads, loss, ∂x2",
    "∂x1 + layer-2 and head gradient parts",
    "w1 gradient parts + loss sum",
    "join + Σg²",
    "norm, clip, Adam",
    "refold",
)
# Rows of the stamp buffers: (updates, stamps an update), as in the .cu.
B4_STAMPS = (256, 16)
B6_STAMPS = (64, 32)
B8_STAMPS = (8192, 8)
B4_GRID_STAMPS = (256, 8)
B6_WIDE_STAMPS = (64, 16)
# The commands' shapes that take the grid-wide routes (learner_cases).
GRID_CASES = (("b4", "hidden512"), ("b4", "batch4096"), ("b6", "island256"))


def stamp_indices(name: str) -> tuple:
    """The SGA_STAMP indices that ``csrc/<name>.cu`` must hold, once each."""
    if name == "dqn_update_kernel":
        return tuple(range(len(B4_PHASES) + 1))
    if name == "tabular_stoch_kernel":
        return tuple(range(len(B8_PHASES) + 1))
    if name == "dqn_update_grid":
        return tuple(range(len(B4_GRID_PHASES) + 1))
    if name == "ppo_wide_kernel":
        return tuple(range(len(B6_WIDE_PHASES) + 1))
    return (tuple(range(len(B6_GRAD_PHASES) + 1))
            + tuple(range(B6_FINISH_FIRST, B6_FINISH_FIRST + len(B6_FINISH_PHASES) + 1)))


def traced_lib(build, name: str, out_dir: Path):
    """``csrc/<name>.cu`` of the ``build`` module's package, compiled with
    ``-DSGA_TRACE`` (its SGA_STAMP markers on) into ``out_dir``."""
    cu = Path(build.CSRC) / f"{name}.cu"
    if "SGA_TRACE" not in cu.read_text():
        raise ValueError(f"{cu} has no SGA_STAMP markers to trace")
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}_traced.so"
    report = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-DSGA_TRACE", "-o", str(so), str(cu)],
        capture_output=True, text=True)
    if report.returncode != 0:
        raise RuntimeError(f"nvcc failed on the traced build:\n{report.stdout}{report.stderr}")
    return ctypes.CDLL(str(so))


def read_stamps(lib, export: str, shape) -> list:
    """The stamp buffer as rows of stamps, one row an update."""
    n_u, n_s = shape
    buf = (ctypes.c_longlong * (n_u * n_s))()
    fn = getattr(lib, export)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    if fn(ctypes.addressof(buf), n_u * n_s) != 0:
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    return [buf[u * n_s:(u + 1) * n_s] for u in range(n_u)]


def b6_stamps(pkg_alias: str, dev, out_dir: Path) -> dict:
    _, pk = lc.variant_ops(pkg_alias)
    build = __import__(f"{pkg_alias}.ops._build", fromlist=["_build"])
    lib = traced_lib(build, "ppo_kernel", out_dir)
    fn = pk.bind(lib)
    pk._lib = lambda: fn
    g = torch.Generator(device=dev).manual_seed(0)
    end = len(B6_GRAD_PHASES)
    result = {}
    for case in ("island", "absent"):
        agent, args = lc.ppo_case(case, dev, g)
        U = args[-1][0].shape[0]
        pk.ppo_optimize(agent, *args)  # warm-up
        torch.cuda.synchronize()
        ms, _ = lc.event_ms(lambda: pk.ppo_optimize(agent, *args))
        rows = read_stamps(lib, "ppo_stamps", B6_STAMPS)
        us = defaultdict(list)
        for row in rows[:U]:
            for i, name in enumerate(B6_GRAD_PHASES):
                us["grad: " + name].append((row[i + 1] - row[i]) / 1e3)
            us["gap between the kernels"].append((row[B6_FINISH_FIRST] - row[end]) / 1e3)
            for i, name in enumerate(B6_FINISH_PHASES):
                at = B6_FINISH_FIRST + i
                us["finish: " + name].append((row[at + 1] - row[at]) / 1e3)
        result[case] = {"U": U, "launch_ms_stamped": ms,
                        "median_us_per_update": {k: statistics.median(v) for k, v in us.items()}}
        print(f"B6 {case}: {ms:.4f} ms per stamped call; median µs per update: " + "; ".join(
            f"{k} {v:.2f}" for k, v in result[case]["median_us_per_update"].items()), flush=True)
    return result


def b4_stamps(pkg_alias: str, dev, out_dir: Path) -> dict:
    duk, _ = lc.variant_ops(pkg_alias)
    build = __import__(f"{pkg_alias}.ops._build", fromlist=["_build"])
    lib = traced_lib(build, "dqn_update_kernel", out_dir)
    fn = duk.bind(lib)
    duk._lib = lambda: fn
    g = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for case in ("sokoban", "whisky"):
        agent, args = lc.dqn_case(case, dev, g)
        U = args[-1].action.shape[0]
        duk.dqn_update(agent, *args)  # warm-up
        torch.cuda.synchronize()
        ms, _ = lc.event_ms(lambda: duk.dqn_update(agent, *args))
        rows = read_stamps(lib, "dqn_update_stamps", B4_STAMPS)
        cycles = defaultdict(list)
        for row in rows[:U]:
            for i, name in enumerate(B4_PHASES):
                cycles[name].append(row[i + 1] - row[i])
        total = sum(sum(v) for v in cycles.values())
        result[case] = {
            "U": U, "B": args[-1].action.shape[1], "launch_ms_stamped": ms,
            "share": {k: sum(v) / total for k, v in cycles.items()},
            "median_cycles_per_update": {k: statistics.median(v) for k, v in cycles.items()},
        }
        print(f"B4 {case}: {ms:.4f} ms per stamped launch; " + "; ".join(
            f"{k} {100 * s:.1f}%" for k, s in result[case]["share"].items()), flush=True)
    return result


def b8_stamps(pkg_alias: str, dev, out_dir: Path) -> dict:
    tsk = __import__(f"{pkg_alias}.ops.tabular_stoch_kernel", fromlist=["tabq_stoch"])
    build = __import__(f"{pkg_alias}.ops._build", fromlist=["_build"])
    lib = traced_lib(build, "tabular_stoch_kernel", out_dir)
    tsk._lib = lambda: tsk.bind(lib)
    g = torch.Generator(device=dev).manual_seed(0)
    result = {}
    cases = [(name, False) for name in lc.B8_CASES] + [("tomato wide", True)]
    for name, hot in cases:
        args = lc.tabq_stoch_case(name, dev, g, hot=hot)
        T, N = args[5].shape
        tsk.tabq_stoch(*args)  # warm-up
        torch.cuda.synchronize()
        ms, _ = lc.event_ms(lambda: tsk.tabq_stoch(*args))
        rows = read_stamps(lib, "tabq_stoch_stamps", B8_STAMPS)[:T]
        cycles = defaultdict(list)
        for row in rows:
            for i, phase in enumerate(B8_PHASES):
                cycles[phase].append(row[i + 1] - row[i])
        total = sum(sum(v) for v in cycles.values())
        key = f"{name}{' hot' if hot else ''}"
        result[key] = {
            "N": N, "T": T, "launch_ms_stamped": ms, "us_per_step": 1e3 * ms / T,
            "tile_steps": tsk.kernel_tile_steps(args[0], N, T),
            "share": {k: sum(v) / total for k, v in cycles.items()},
            "median_cycles_per_step": {k: statistics.median(v) for k, v in cycles.items()},
        }
        print(f"B8 {key}: {ms:.4f} ms per stamped launch ({1e3 * ms / T:.3f} µs a step, stream "
              f"tiles of {result[key]['tile_steps']} steps); " + "; ".join(
                  f"{k} {100 * v:.1f}% ({result[key]['median_cycles_per_step'][k]:.0f} cycles)"
                  for k, v in result[key]["share"].items()), flush=True)
    return result


def grid_case(pkg_alias: str, kernel: str, name: str, dev, g):
    """``(call, U)`` of a grid-wide route's case through the package's
    wrapper."""
    duk, pk = lc.variant_ops(pkg_alias)
    if kernel == "b4":
        agent, args = lc.dqn_case(name, dev, g)
        return (lambda: duk.dqn_update(agent, *args)), args[-1].action.shape[0]
    agent, args = lc.ppo_case(name, dev, g)
    return (lambda: pk.ppo_optimize(agent, *args)), args[-1][0].shape[0]


def grid_times(pkg_alias: str, dev) -> dict:
    """Event, profiler and fenced device ms of each grid-wide case."""
    g = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for kernel, name in GRID_CASES:
        call, U = grid_case(pkg_alias, kernel, name, dev, g)
        event = statistics.median(lc.event_ms(call)[0] for _ in range(5))
        split = kernel_split(call)
        prof = sum(v["ms_per_call"] for v in split.values())
        fenced = lc.fenced_ms(call)
        result[f"{kernel} {name}"] = {"U": U, "event_ms": event, "profiler_ms": prof,
                                      "fenced_ms": fenced, "kernels": split}
        print(f"{kernel.upper()} {name}: event {event:.4f} ms; device by profiler {prof:.4f} "
              f"ms, by fenced events {fenced:.4f} ms ({1e3 * fenced / U:.1f} µs an update)",
              flush=True)
    return result


def grid_stamps(pkg_alias: str, dev, out_dir: Path) -> dict:
    """Phase times of the grid-wide routes from stamped builds."""
    duk, pk = lc.variant_ops(pkg_alias)
    build = __import__(f"{pkg_alias}.ops._build", fromlist=["_build"])
    libs = {"b4": traced_lib(build, "dqn_update_grid", out_dir),
            "b6": traced_lib(build, "ppo_wide_kernel", out_dir)}
    b4_fn, b6_fn = duk.bind_grid(libs["b4"]), pk.bind_wide(libs["b6"])
    duk._grid_lib, pk._wide_lib = (lambda: b4_fn), (lambda: b6_fn)
    g = torch.Generator(device=dev).manual_seed(0)
    result = {}
    for kernel, name in GRID_CASES:
        call, U = grid_case(pkg_alias, kernel, name, dev, g)
        call()  # warm-up
        torch.cuda.synchronize()
        ms, _ = lc.event_ms(call)
        export, shape, phases = (("dqn_update_grid_stamps", B4_GRID_STAMPS, B4_GRID_PHASES)
                                 if kernel == "b4" else
                                 ("ppo_wide_stamps", B6_WIDE_STAMPS, B6_WIDE_PHASES))
        rows = read_stamps(libs[kernel], export, shape)[:U]
        us = defaultdict(list)
        for u, row in enumerate(rows):
            for i, phase in enumerate(phases):
                if kernel == "b6" and i == len(phases) - 1 and u == U - 1:
                    continue  # no refold after the last update
                us[phase].append((row[i + 1] - row[i]) / 1e3)
        med = {k: statistics.median(v) for k, v in us.items()}
        result[f"{kernel} {name}"] = {"U": U, "launch_ms_stamped": ms,
                                      "median_us_per_update": med}
        print(f"{kernel.upper()} {name}: {ms:.4f} ms per stamped call; median µs per update "
              "(barrier included): " + "; ".join(f"{k} {v:.2f}" for k, v in med.items()),
              flush=True)
    return result


def per_call_us(call, n: int = 200) -> float:
    """Host µs per call of ``call``, ``n`` calls back to back
    (``time.perf_counter_ns``), after one warm-up call."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        call()
    ns = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return ns / n / 1e3


def b5_launch_parts(pck, args, n: int = 200) -> dict:
    """Host µs per call of each part of the ``ppo_collect`` wrapper of the
    module ``pck`` (this package's or the parent's), timed alone as the
    wrapper runs it: the input checks, the output allocation (one carved
    buffer, or the first design's 18 ``torch.empty``), the device and stream
    lookup (``current_device`` and ``stream_of``, or a ``torch.cuda.device``
    context and ``current_stream``), and the ctypes call with its pointer
    arguments (which launches the kernel); and the whole wrapper."""
    tables, rows, state, u = args
    T, N = u.shape
    S, A = tables.shape
    dev = u.device

    def checks():
        pck.check_tables(tables, dev)
        pck.check_rows(rows, S, A, dev)
        pck.check_state(state, N, dev)
        pck.check_tensor(u, torch.float32, (T, N), dev, "u")
        pck.check_smem(pck.smem_bytes(S, A), tables)

    carved = hasattr(pck, "carve_outputs")
    if carved:
        def alloc():
            return pck.carve_outputs(T, N, dev)

        def lookup():
            with pck.current_device(dev):
                return pck.stream_of(dev)
    else:
        from ..ops.ppo_collect_kernel import RECORD_DTYPES
        from ..ops.rollout_kernel import STATE_DTYPES

        def alloc():
            return (tuple(torch.empty((1, N), dtype=d, device=dev) for d in STATE_DTYPES)
                    + tuple(torch.empty((1, N), dtype=torch.float32, device=dev)
                            for _ in range(4))
                    + tuple(torch.empty((T, N), dtype=d, device=dev) for d in RECORD_DTYPES))

        def lookup():
            with torch.cuda.device(dev):
                return torch.cuda.current_stream(dev).cuda_stream
    fn = pck._lib()
    stream = lookup()
    outs = alloc()
    head = (rows.logp, rows.cdf, rows.value)

    def ctypes_call():
        if carved:
            return fn(*tables.pointers(), *(x.data_ptr() for x in head), S, A,
                      tables.max_steps, tables.reset_idx, *(x.data_ptr() for x in state),
                      u.data_ptr(), T, N, outs[0].data_ptr(), stream)
        return fn(*tables.pointers(), *(x.data_ptr() for x in head), S, A, tables.max_steps,
                  tables.reset_idx, *(x.data_ptr() for x in state), u.data_ptr(), T, N,
                  *(x.data_ptr() for x in outs), stream)

    parts = {"checks": per_call_us(checks, n), "allocation": per_call_us(alloc, n),
             "device and stream": per_call_us(lookup, n),
             "ctypes call": per_call_us(ctypes_call, n),
             "wrapper": per_call_us(lambda: pck.ppo_collect(*args), n)}
    parts["rest"] = parts["wrapper"] - sum(v for k, v in parts.items() if k != "wrapper")
    return parts


def launch_split(pkg_alias: str, dev, profiler: bool = True) -> dict:
    """The split of each case's CUDA-event time into device time and launch
    path, for the package ``pkg_alias``; ``profiler=False`` leaves out
    ``torch.profiler`` (``chip_smoke.py``, whose long process loses some
    profiler sessions) and keeps the fenced device time."""
    tsk, psk = lc.variant_stoch_ops(pkg_alias)
    pck = lc.variant_module(pkg_alias, "ppo_collect_kernel")
    fm = lc.variant_module(pkg_alias, "fused_mlp")
    from .ab_learners import host_us
    g = torch.Generator(device=dev).manual_seed(0)
    calls = {f"b8 {name}": (lambda x=lc.tabq_stoch_case(name, dev, g): tsk.tabq_stoch(*x))
             for name in ("absent cli", "tomato cli", "whisky cli")}
    calls["b10 absent main"] = (lambda x=lc.ppo_stoch_case("absent main", dev, g):
                                psk.ppo_stoch_collect(*x))
    b5_args = lc.ppo_collect_case("island main", dev, g)
    calls["b5 island main"] = lambda: pck.ppo_collect(*b5_args)
    for name, B in lc.B11_CASES.items():
        calls[f"b11 {name}"] = (lambda x=lc.fused_mlp_case(B, dev, g): fm.fused_mlp_forward(*x))
    result = {}
    for case, call in calls.items():
        event = statistics.median(lc.event_ms(call)[0] for _ in range(21))
        prof = (sum(v["ms_per_call"] for v in kernel_split(call, 5).values()) if profiler
                else None)
        result[case] = {"event_ms": event, "profiler_ms": prof, "fenced_ms": lc.fenced_ms(call),
                        "host_us": host_us(call)}
        r = result[case]
        by_profiler = f"by profiler {prof:.4f} ms, " if profiler else ""
        print(f"{case}: event {event:.4f} ms; device {by_profiler}by fenced events "
              f"{r['fenced_ms']:.4f} ms; host launch path {r['host_us']:.1f} µs", flush=True)
    parts = b5_launch_parts(pck, b5_args)
    result["b5 island main"]["parts_us"] = parts
    print("b5 island main launch path by part (µs a call, 200 calls each): " + "; ".join(
        f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
    return result


def kernel_split(call, reps: int = 3, attempts: int = 3) -> dict:
    """Device ms per call summed by kernel name (``torch.profiler``). On the
    card host a profiler session now and then records no device activity
    (seen on every other session in one process); such a session is run
    again, up to ``attempts`` sessions, and ``RuntimeError`` is raised if
    none records any."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        split = {}
        for evt in prof.key_averages():
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            if t <= 0:
                continue
            name = re.sub(r"^(void )?\(anonymous namespace\)::", "", evt.key).split("(")[0]
            split[name] = {"ms_per_call": t / 1e3 / reps, "launches_per_call": evt.count / reps}
        if split:
            return split
    raise RuntimeError(f"torch.profiler recorded no device time in {attempts} sessions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", default=None,
                   help="root holding the safe_grid_agents_torch package to trace")
    p.add_argument("--b4-stamps", action="store_true",
                   help="phase shares of B4 from a stamped copy of its source")
    p.add_argument("--b6-stamps", action="store_true",
                   help="phase times of the persistent B6 design from a stamped copy")
    p.add_argument("--b8-stamps", action="store_true",
                   help="per-step phase shares of B8 from a stamped copy of its source")
    p.add_argument("--grid-stamps", action="store_true",
                   help="phase times of B4's grid and B6's wide routes from stamped copies")
    p.add_argument("--launch-split", action="store_true",
                   help="B8, B10, B5 and B11 at the main path's shapes: device time against "
                        "the launch path, and B5's launch path by part")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_learners: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    alias = "safe_grid_agents_torch"
    if args.package:
        alias = "sga_traced"
        lc.load_package(args.package, alias)
    duk, pk = lc.variant_ops(alias)
    result = {"card": lc.nvidia_smi("name,power.limit"), "package": args.package or "this"}
    print(f"card {result['card']}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    result["b6"] = {}
    for case in ("island", "absent"):
        agent, call_args = lc.ppo_case(case, dev, g)
        ms = statistics.median(lc.event_ms(lambda: pk.ppo_optimize(agent, *call_args))[0]
                               for _ in range(5))
        split = kernel_split(lambda: pk.ppo_optimize(agent, *call_args))
        result["b6"][case] = {"event_ms": ms, "kernels": split}
        print(f"B6 {case}: {ms:.4f} ms per call; " + "; ".join(
            f"{k} {v['ms_per_call']:.4f} ms ({v['launches_per_call']:.0f} launches)"
            for k, v in sorted(split.items(), key=lambda kv: -kv[1]["ms_per_call"])),
            flush=True)
    result["b4"] = {}
    for case in ("sokoban", "whisky"):
        agent, call_args = lc.dqn_case(case, dev, g)
        ms = statistics.median(lc.event_ms(lambda: duk.dqn_update(agent, *call_args))[0]
                               for _ in range(5))
        split = kernel_split(lambda: duk.dqn_update(agent, *call_args))
        result["b4"][case] = {"event_ms": ms, "kernels": split}
        print(f"B4 {case}: {ms:.4f} ms per call; {split}", flush=True)
    if args.b4_stamps:
        build_dir = Path(__import__(f"{alias}.ops._build", fromlist=["_build"]).BUILD_DIR)
        result["b4_stamps"] = b4_stamps(alias, dev, build_dir / "trace")
    if args.b6_stamps:
        build_dir = Path(__import__(f"{alias}.ops._build", fromlist=["_build"]).BUILD_DIR)
        result["b6_stamps"] = b6_stamps(alias, dev, build_dir / "trace")
    result["grid"] = grid_times(alias, dev)
    if args.grid_stamps:
        build_dir = Path(__import__(f"{alias}.ops._build", fromlist=["_build"]).BUILD_DIR)
        result["grid_stamps"] = grid_stamps(alias, dev, build_dir / "trace")
    if args.launch_split:
        result["launch_split"] = launch_split(alias, dev)
    if args.b8_stamps:
        build_dir = Path(__import__(f"{alias}.ops._build", fromlist=["_build"]).BUILD_DIR)
        result["b8_stamps"] = b8_stamps(alias, dev, build_dir / "trace")
    result["clocks_after"] = lc.nvidia_smi("clocks.sm,power.draw,temperature.gpu")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
