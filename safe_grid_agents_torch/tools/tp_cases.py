"""Cases of the model axis (``parallel/tp.py``), the pipeline, expert and
ring-attention demos (``parallel/pp.py``, ``ep.py``, ``sp.py``) and resume
under several ranks, run by their tests and by ``chip_smoke.py`` phase 10
(``parallel.launch.spawn`` imports these functions in fresh processes, so
this module imports the port and nothing else).

* ``CASES`` / ``CARD_CASES``: the deep trainers ``TPTrainer`` wraps, small
  (the tests) and at the island preset's and the sokoban preset's full
  width (the card);
* ``tp_jobs``: rank-side, on 4 ranks (or 2): each case's chunks unwrapped
  and under ``TPTrainer`` at (D 1, M 2), and where there are 4 ranks under
  ``DPTrainer`` at W 2 and ``TPTrainer`` at (D 2, M 2); the sharded forward
  of handed-over params, a column-sharded matmul, and the CLI's ``--tp``;
* ``demo_jobs``: rank-side, the three demos' forward and backward on
  handed-over inputs, their state's shapes, a training run of each;
* ``resume_jobs``: rank-side, the CLI's straight run against a half run
  resumed to the same length, each rank's final checkpoint file bitwise;
* ``card_phase``: ``chip_smoke.py`` phase 10, on two gloo ranks sharing
  the card (``card_ranks``, checked by ``compare``, ``demo_reference`` and
  ``demo_errors``). Alone:

      python -m safe_grid_agents_torch.tools.tp_cases [--platform cpu]
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..agents.crmdp import PPOCRMDPAgent
from ..agents.dqn import DQNAgent
from ..agents.ppo import PPOAgent
from ..envs import make_env
from ..envs.array_vec import ArrayVecEnv
from ..parallel import ep, pp, sp
from ..parallel.collectives import all_gather_lanes, psum
from ..parallel.dp import DPTrainer, rank_seed
from ..parallel.mesh import make_mesh
from ..parallel.tp import TPPlan, TPTrainer, tp_param_specs
from ..training import CRMDPTrainer, DQNTrainer, PPOTrainer
from ..utils import checkpoint as ckpt
from .dp_cases import cpu_leaves

# name -> the trainer's alias (compiled: the array engine over the compiled
# env, for the table-folded nets), agent and its kwargs, the trainer's
# updates a chunk, global lanes, chunk length, chunks, warmup steps. The CNN
# and the table nets carry gradients into the input of a column-parallel
# layer (copy_to_model's backward); the 3-layer Q net ends on a row layer.
CASES = {
    "ppo": dict(alias="island", agent="ppo", n_envs=32, T=8, chunks=2, warmup=0,
                kw=dict(hidden=(64, 64), epochs=2, n_minibatches=2)),
    "dqn-per": dict(alias="sokoban", agent="dqn", n_envs=32, T=8, chunks=2, warmup=16,
                    kw=dict(hidden=(64, 64), batch_size=64, replay_capacity=512,
                            prioritized=True, double_q=True, sync_every=3), updates=4),
    "ppo-cnn": dict(alias="corners", agent="ppo", n_envs=16, T=8, chunks=2, warmup=0,
                    kw=dict(net="cnn", hidden=(32,), epochs=2, n_minibatches=2)),
    "crmdp-table": dict(alias="corners", agent="crmdp", compiled=True, n_envs=16, T=8,
                        chunks=2, warmup=0, kw=dict(net="table", hidden=(32, 32), epochs=2,
                                                    n_minibatches=2, crmdp_lr=1.0)),
    "dqn-table-3": dict(alias="sokoban", agent="dqn", compiled=True, n_envs=16, T=8,
                        chunks=2, warmup=8, updates=2,
                        kw=dict(table=True, hidden=(32, 32, 32), batch_size=32,
                                replay_capacity=256, sync_every=3)),
}
# The island ppo-mlp preset (288 -> 128 -> 128, N 1024, one chunk of 64) and
# the sokoban deep-q preset (144 -> 128 -> 128 -> 4, N 128, warmup 40, one
# chunk of 32), presets.json.
CARD_CASES = {
    "island": dict(alias="island", agent="ppo", n_envs=1024, T=64, chunks=1, warmup=0,
                   kw=dict(lr=5e-4, entropy_bonus=0.5, entropy_final=0.0,
                           entropy_anneal_steps=3_000_000)),
    "sokoban": dict(alias="sokoban", agent="dqn", n_envs=128, T=32, chunks=1, warmup=40,
                    kw=dict(lr=5e-4, epsilon_anneal_steps=60_000, batch_size=128,
                            replay_capacity=50_000, sync_every=100)),
}
# test_tp.py's tolerances (tests/test_tp.py:70-83).
TP_TOL = dict(loss=dict(rtol=1e-4, atol=1e-5), params=dict(rtol=2e-4, atol=2e-5),
              return_sum=dict(rtol=1e-5, atol=0.0))


def build(case: dict, device):
    """A trainer of ``case`` over its global lanes on ``device`` (the array
    engine, over the compiled env where ``case["compiled"]``)."""
    env = (make_env(case["alias"], compiled=True, device=device) if case.get("compiled")
           else make_env(case["alias"]))
    vec = ArrayVecEnv(env, case["n_envs"], device)
    if case["agent"] == "ppo":
        return PPOTrainer(PPOAgent(env, **case["kw"]), vec)
    if case["agent"] == "crmdp":
        return CRMDPTrainer(PPOCRMDPAgent(env, **case["kw"]), vec)
    return DQNTrainer(DQNAgent(env, **case["kw"]), vec,
                      updates_per_chunk=case.get("updates"))


def run_case(trainer, case: dict, generator: torch.Generator, seed: int = 0):
    """``init``, the warmup, then ``case``'s chunks: ``(astate, [(stats,
    loss) a chunk])``."""
    astate, vstate = trainer.init(seed=seed, generator=generator)
    if case["warmup"]:
        astate, vstate, _ = trainer.warmup_chunk(astate, vstate, generator, case["warmup"])
    chunks = []
    for _ in range(case["chunks"]):
        astate, vstate, stats, loss = trainer.train_chunk(astate, vstate, generator,
                                                          case["T"])
        chunks.append((stats, loss))
    return astate, chunks


def summary(astate, chunks) -> dict:
    """The learner leaves (the replay storage left out), each chunk's summed
    stats and loss, as CPU tensors."""
    out = {"state": cpu_leaves(astate, skip=("buffer/storage",)), "chunks": []}
    for stats, loss in chunks:
        out["chunks"].append({**cpu_leaves(stats), "loss": loss.detach().cpu()})
    return out


def compare(got: dict, want: dict) -> dict:
    """``got`` (a TP run's ``summary``) against ``want`` within ``TP_TOL``:
    the worst float leaf's error and its bound, the integer leaves equal,
    each chunk's loss, episodes, env steps and ``return_sum``; ``ok`` where
    all hold."""
    tol = TP_TOL
    worst, ok = (None, 0.0, 0.0), sorted(got["state"]) == sorted(want["state"])
    for k, w in want["state"].items():
        g = got["state"].get(k)
        if g is None or g.shape != w.shape or g.dtype != w.dtype:
            ok = False
            continue
        if not w.dtype.is_floating_point:
            ok = ok and torch.equal(g, w)
            continue
        err = (g.double() - w.double()).abs()
        bound = tol["params"]["atol"] + tol["params"]["rtol"] * w.double().abs()
        ok = ok and bool((err <= bound).all())
        if float(err.max()) > worst[1]:
            worst = (k, float(err.max()), float(bound.min()))
    chunks = []
    for g, w in zip(got["chunks"], want["chunks"]):
        loss_err = abs(float(g["loss"]) - float(w["loss"]))
        ret_err = abs(float(g["return_sum"]) - float(w["return_sum"]))
        rec = {"loss": float(g["loss"]), "loss_err": loss_err,
               "episodes": float(g["episodes"]),
               "episodes_equal": float(g["episodes"]) == float(w["episodes"]),
               "return_sum_err": ret_err}
        ok = (ok and rec["episodes_equal"]
              and float(g["env_steps"]) == float(w["env_steps"])
              and loss_err <= tol["loss"]["atol"] + tol["loss"]["rtol"] * abs(float(w["loss"]))
              and ret_err <= tol["return_sum"]["rtol"] * abs(float(w["return_sum"])))
        chunks.append(rec)
    return {"ok": ok, "worst_leaf": worst, "chunks": chunks}


def _gen(device, seed: int, data_index: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(rank_seed(seed, data_index))


def _meshes(device):
    """At 2 ranks the (D 1, M 2) mesh; at 4 the (D 2, M 2) mesh and, as a
    (D 1, M 2) mesh, its model pair with a data axis of this rank alone
    (every rank creates every one-rank group)."""
    if dist.get_world_size() == 2:
        return make_mesh(1, 2, device), None
    mesh22 = make_mesh(2, 2, device)
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())]
    return dataclasses.replace(mesh22, group=alone[dist.get_rank()], world_size=1,
                               rank=0), mesh22


def tp_case(case: dict, mesh12, mesh22, seed: int = 0) -> dict:
    """Rank-side: ``case`` unwrapped, under ``TPTrainer`` at (D 1, M 2), and
    with ``mesh22`` under ``DPTrainer`` at W 2 and ``TPTrainer`` at (D 2, M
    2); the TP states made whole. Every generator is seeded by the rank's
    data index, as the CLI seeds them."""
    dev = mesh12.device
    out = {"single": summary(*run_case(build(case, dev), case, _gen(dev, seed, 0), seed))}
    tp = TPTrainer(build(case, dev), mesh12)
    a, chunks = run_case(tp, case, _gen(dev, seed, 0), seed)
    out["shapes"] = {f"{k}/{n}": tuple(v.shape) for k in ("params", "mu")
                     for n, v in (getattr(a, k).items() if isinstance(getattr(a, k), dict)
                                  else [("flat", getattr(a, k))])}
    out["specs"] = tp.specs
    out["tp12"] = summary(tp.plan.gather_state(a), chunks)
    if mesh22 is not None:
        g = _gen(dev, seed, mesh22.rank)
        out["dp2"] = summary(*run_case(DPTrainer(build(case, dev), mesh22), case, g, seed))
        tp = TPTrainer(build(case, dev), mesh22)
        a, chunks = run_case(tp, case, _gen(dev, seed, mesh22.rank), seed)
        out["tp22"] = summary(tp.plan.gather_state(a), chunks)
        out["lanes22"] = tp.vec.n_envs
    return out


def tp_forward(mesh12, params: Dict[str, np.ndarray], obs: np.ndarray,
               hidden=(64, 64)) -> dict:
    """Rank-side: the island actor-critic's forward on ``obs`` with the
    (whole) ``params`` cut to this rank's shards over the model pair."""
    dev = mesh12.device
    agent = PPOAgent(make_env("island"), hidden=hidden)
    whole = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in params.items()}
    plan = TPPlan(agent.net, tp_param_specs(whole), mesh12.model)
    net = plan.shard_net(agent.net)
    with torch.no_grad():
        logits, value = net.apply(plan.shard_params(whole), torch.from_numpy(obs).to(dev))
    return {"logits": logits.cpu(), "value": value.cpu()}


def column_matmul(mesh22, x: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """Rank-side twin of ``tests/test_dp.py:146``: ``relu(x @ w)`` with the
    rows of ``x`` over ``data`` and the columns of ``w`` over ``model``,
    then made whole over both axes."""
    dev = mesh22.device
    x = torch.from_numpy(x).to(dev)[mesh22.lanes(x.shape[0])]
    m = mesh22.model
    k = w.shape[1] // m.world_size
    w = torch.from_numpy(w[:, m.rank * k:(m.rank + 1) * k].copy()).to(dev)
    y = torch.relu(x @ w)
    return all_gather_lanes(all_gather_lanes(y, m, 1), mesh22, 0).cpu()


def tp_jobs(jobs: dict, seed: int = 0, device=None) -> dict:
    """Rank-side (4 ranks, or 2: then no W 2 / D 2 legs): ``jobs`` maps
    "cases" to ``{name: case}``, "forward" to ``(params, obs)``, "matmul"
    to ``(x, w)`` and "cli" to a CLI argv run on all the ranks."""
    mesh12, mesh22 = _meshes(device)
    out = {"rank": dist.get_rank()}
    for name, case in jobs.get("cases", {}).items():
        out[name] = tp_case(case, mesh12, mesh22, seed)
    if "forward" in jobs:
        out["forward"] = tp_forward(mesh12, *jobs["forward"])
    if "matmul" in jobs and mesh22 is not None:
        out["matmul"] = column_matmul(mesh22, *jobs["matmul"])
    if "cli" in jobs:
        from ..cli.main import run

        with contextlib.redirect_stdout(io.StringIO()):
            out["cli"] = run(jobs["cli"])
    return out


# ---- the demos ---------------------------------------------------------------------------

def _grads(loss, leaves):
    return [torch.zeros_like(x) if g is None else g for x, g in
            zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


def _req(tree: dict, device) -> dict:
    """Leaves (tensors or numpy) as fresh leaf tensors on ``device`` that
    require gradients."""
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v))).to(device).requires_grad_(True)
            for k, v in tree.items()}


def demo_pp(c: dict, device=None) -> dict:
    """Rank-side pipeline: ``c`` holds the whole ``params``, ``xs`` and
    ``targets`` (numpy); the forward, this stage's gradients and shapes,
    and the losses of ``c["steps"]`` training steps towards
    ``c["train_targets"]``."""
    g = pp.make_pp_mesh(c["params"]["w"].shape[0], device)
    dev = g.device
    mine = pp.place_pp(g, {k: torch.from_numpy(v) for k, v in c["params"].items()})
    xs, t = (torch.from_numpy(c[k]).to(dev) for k in ("xs", "targets"))
    leaves = _req(mine, dev)
    ys = pp.pipeline_apply(g, leaves, xs)
    grads = _grads(torch.square(ys - t).mean(), [leaves["w"], leaves["b"]])
    params, losses = mine, []
    t = torch.from_numpy(c["train_targets"]).to(dev)
    for _ in range(c["steps"]):
        params, loss = pp.pp_train_step(g, params, xs, t, c["lr"])
        losses.append(float(loss))
    return {"ys": ys.detach().cpu(), "w": grads[0].cpu(), "b": grads[1].cpu(),
            "shapes": {k: tuple(v.shape) for k, v in mine.items()},
            "losses": losses, "stage": g.rank}


def demo_ep(c: dict, device=None) -> dict:
    """Rank-side MoE: ``c`` holds the whole ``params``, ``xs`` and
    ``targets`` ``[E, b, d]`` and ``capacity``; this rank's tokens through
    the layer, the gradients (the expert's own, the router's summed), the
    capacity-1 output, and the losses of ``c["steps"]`` training steps
    towards ``c["train_targets"]``."""
    g = ep.make_ep_mesh(c["params"]["w_in"].shape[0], device)
    dev, r = g.device, g.rank
    mine = ep.place_ep(g, {k: torch.from_numpy(v) for k, v in c["params"].items()})
    xs = torch.from_numpy(c["xs"][r:r + 1].copy()).to(dev)
    t = torch.from_numpy(c["targets"][r:r + 1].copy()).to(dev)
    leaves = _req(mine, dev)
    ys = ep.ep_moe_apply(g, leaves, xs, c["capacity"])
    n = t.numel() * g.world_size
    names = ("router", "w_in", "w_out")
    grads = dict(zip(names, _grads(torch.square(ys - t).sum() / n,
                                   [leaves[k] for k in names])))
    grads["router"] = psum(grads["router"], g)  # replicated: every rank's tokens
    with torch.no_grad():
        ys1 = ep.ep_moe_apply(g, mine, xs, 1)
    params, losses = mine, []
    t = torch.from_numpy(c["train_targets"][r:r + 1].copy()).to(dev)
    for _ in range(c["steps"]):
        params, loss = ep.ep_train_step(g, params, xs, t, c["capacity"], c["lr"])
        losses.append(float(loss))
    return {"ys": ys.detach().cpu(), "ys_cap1": ys1.cpu(),
            **{f"grad_{k}": v.cpu() for k, v in grads.items()},
            "shapes": {k: tuple(v.shape) for k, v in mine.items()},
            "losses": losses, "expert": r}


def demo_sp(c: dict, device=None) -> dict:
    """Rank-side ring attention: ``c`` holds the whole ``q``, ``k``, ``v``
    and ``targets`` ``[L, d]`` and the shard count; this rank's block of
    the output, its blocks' gradients, and the shapes of every tensor the
    forward and backward made (``torch`` dispatch), to show no ``[L, L]``
    score matrix is formed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor):
                    self.seen.add(tuple(x.shape))
            return out

    g = sp.make_sp_mesh(c["shards"], device)
    dev = g.device
    q, k, v, t = sp.place_sp(g, *(torch.from_numpy(c[n]) for n in ("q", "k", "v", "targets")))
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    shapes = Shapes()
    with shapes:
        out = sp.ring_attention(g, *leaves)
        grads = _grads(torch.square(out - t).sum() / (t.numel() * g.world_size), leaves)
    return {"out": out.detach().cpu(), **{f"grad_{n}": x.cpu() for n, x in zip("qkv", grads)},
            "shapes": sorted(shapes.seen), "block": tuple(out.shape), "shard": g.rank}


def demo_jobs(jobs: dict, device=None) -> dict:
    """Rank-side: the demos of ``jobs`` ("pp", "ep", "sp") on their cases."""
    fns = {"pp": demo_pp, "ep": demo_ep, "sp": demo_sp}
    return {name: fns[name](c, device) for name, c in jobs.items()}


# ---- resume under several ranks ----------------------------------------------------------

# name -> (flags, full steps, half steps, chunks of the full run): 2 ranks.
RESUME_TWINS = {
    "tabular": (["shift", "tabular-q", "--n-envs", "32", "--chunk-steps", "16",
                 "--lr", "0.2"], 4096, 2048, 8),
    "dqn per": (["sokoban", "deep-q", "--n-envs", "32", "--chunk-steps", "16",
                 "--batch-size", "32", "--replay-capacity", "1024", "--sync-every", "10",
                 "--warmup-steps", "8", "--n-hidden", "32", "--prioritized"],
                4096, 2048, 8),
    "ppo": (["island", "ppo-mlp", "--n-envs", "32", "--chunk-steps", "16", "--n-hidden",
             "32", "--lr", "0.001"], 4096, 2048, 8),
    "ppo tp": (["island", "ppo-mlp", "--n-envs", "32", "--chunk-steps", "16", "--n-hidden",
                "32", "--lr", "0.001", "--tp", "2"], 4096, 2048, 8),
}


def twin_argv(name: str, steps: int, ckdir: str, platform: str, world: int) -> list:
    flags = RESUME_TWINS[name][0]
    return flags + ["--eval-every", "1", "--eval-steps", "30", "--checkpoint-every", "2",
                    "--seed", "7", "--platform", platform, "--n-devices", str(world),
                    "--steps", str(steps), "--checkpoint-dir", ckdir]


def resume_twin_rank(name: str, workdir: str, platform: str) -> dict:
    """Rank-side: ``name``'s straight run and its half run resumed to the
    same length, on all the ranks; this rank's final files compared leaf by
    leaf, bitwise."""
    from ..cli.main import run

    rank, world = dist.get_rank(), dist.get_world_size()
    _, full, half, n_chunks = RESUME_TWINS[name]
    dirs = {k: os.path.join(workdir, name.replace(" ", "_"), k)
            for k in ("straight", "resumed")}
    finals, texts = {}, {}
    for run_name, steps, ckdir, extra in (("straight", full, dirs["straight"], []),
                                          ("half", half, dirs["resumed"], []),
                                          ("resumed", full, dirs["resumed"], ["--resume"])):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            finals[run_name] = run(twin_argv(name, steps, ckdir, platform, world) + extra)
        texts[run_name] = text.getvalue()
    a = ckpt.read(dirs["straight"], n_chunks, rank=rank)
    b = ckpt.read(dirs["resumed"], n_chunks, rank=rank)
    differ = sorted(k for k in a if not isinstance(a[k], torch.Tensor) and a[k] != b.get(k)
                    or isinstance(a[k], torch.Tensor) and not (
                        isinstance(b.get(k), torch.Tensor) and a[k].dtype == b[k].dtype
                        and torch.equal(a[k], b[k])))
    return {"rank": rank, "leaves": len(a), "same_keys": sorted(a) == sorted(b),
            "differ": differ, "finals": finals,
            "resumed_line": "resumed from chunk" in texts["resumed"],
            "half_resumed": "resumed from chunk" in texts["half"],
            "layout": ckpt.step_layout(dirs["resumed"], n_chunks)}


def resume_jobs(names, workdir: str, platform: str = "cpu") -> Dict[str, dict]:
    """Rank-side: ``resume_twin_rank`` of each of ``names``."""
    return {name: resume_twin_rank(name, workdir, platform) for name in names}


def first_failure(ranks: list) -> Optional[str]:
    """A resume twin's first fault over the ranks' records, or None."""
    for rec in ranks:
        for name, r in rec.items():
            if not r["same_keys"] or r["differ"] or not r["resumed_line"] or r["half_resumed"]:
                return f"{name} rank {r['rank']}: {r['differ'][:5]}"
            if json.dumps(r["finals"]["straight"]) != json.dumps(r["finals"]["resumed"]):
                return f"{name} rank {r['rank']}: final evals differ"
    return None


# ---- chip_smoke.py phase 10 ----------------------------------------------------------------

def demo_cases(world: int, seed: int = 0) -> dict:
    """The three demos at ``world`` ranks, at the reference tests' other
    shapes (pp: L 2, D 16, M 6, MB 4; ep: 8 tokens a rank, D 16, H 32,
    capacity 8; sp: L 32, D 16), inputs from a numpy generator."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    S, D = world, 16
    params = {k: v.numpy() for k, v in pp.init_pp_params(seed, S, D, 2).items()}
    moe = {k: v.numpy() for k, v in ep.init_moe_params(seed, S, D, 32).items()}
    return {"pp": {"params": params, "xs": normal(6, 4, D), "targets": normal(6, 4, D),
                   "train_targets": normal(6, 4, D), "steps": 3, "lr": 0.05},
            "ep": {"params": moe, "xs": normal(S, 8, D), "targets": normal(S, 8, D),
                   "train_targets": normal(S, 8, D), "capacity": 8, "steps": 3, "lr": 0.05},
            "sp": {"q": normal(32, D), "k": normal(32, D), "v": normal(32, D),
                   "targets": normal(32, D), "shards": S}}


def demo_reference(cases: dict, device) -> dict:
    """The demos' single-process programs on ``cases`` (``demo_cases``):
    the forward and the whole gradients, as numpy."""
    out = {}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    c = cases["pp"]
    p = _req(c["params"], device)
    ys = pp.sequential_apply(p, t(c["xs"]))
    gw, gb = _grads(torch.square(ys - t(c["targets"])).mean(), [p["w"], p["b"]])
    out["pp"] = {"ys": ys, "w": gw, "b": gb}
    c = cases["ep"]
    p = _req(c["params"], device)
    d = c["xs"].shape[-1]
    ys = ep.dense_moe_apply(p, t(c["xs"]).reshape(-1, d))
    names = ("router", "w_in", "w_out")
    grads = _grads(torch.square(ys - t(c["targets"]).reshape(-1, d)).mean(),
                   [p[k] for k in names])
    out["ep"] = {"ys": ys.reshape(c["xs"].shape),
                 **{f"grad_{k}": g for k, g in zip(names, grads)}}
    c = cases["sp"]
    qkv = [t(c[n]).requires_grad_(True) for n in "qkv"]
    o = sp.full_attention(*qkv)
    grads = _grads(torch.square(o - t(c["targets"])).mean(), qkv)
    out["sp"] = {"out": o, **{f"grad_{n}": g for n, g in zip("qkv", grads)}}
    return {k: {n: x.detach().cpu().numpy() for n, x in v.items()} for k, v in out.items()}


def demo_errors(ranks: list, ref: dict) -> Dict[str, dict]:
    """Each demo's largest forward and backward error, over the ranks, of the
    ranks' results against ``demo_reference``."""
    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    out = {}
    by = {name: sorted((r[name] for r in ranks),
                       key=lambda r: r.get("stage", r.get("expert", r.get("shard"))))
          for name in ("pp", "ep", "sp")}
    pr = ref["pp"]
    out["pp"] = {"forward": max(err(r["ys"], pr["ys"]) for r in by["pp"]),
                 "backward": max(err(r[k], pr[k][i:i + 1]) for i, r in enumerate(by["pp"])
                                 for k in ("w", "b"))}
    er = ref["ep"]
    out["ep"] = {"forward": err(np.concatenate([r["ys"] for r in by["ep"]]), er["ys"]),
                 "backward": max([err(r["grad_router"], er["grad_router"]) for r in by["ep"]]
                                 + [err(r[f"grad_{k}"], er[f"grad_{k}"][i:i + 1])
                                    for i, r in enumerate(by["ep"])
                                    for k in ("w_in", "w_out")])}
    sr = ref["sp"]
    out["sp"] = {"forward": err(np.concatenate([r["out"] for r in by["sp"]]), sr["out"]),
                 "backward": max(err(np.concatenate([r[f"grad_{n}"] for r in by["sp"]]),
                                     sr[f"grad_{n}"]) for n in "qkv")}
    return out


def card_ranks(jobs: dict, workdir: str, platform: str = "cuda") -> dict:
    """Rank-side on the card (``chip_smoke.py`` phase 10; gloo ranks sharing
    it): ``jobs["cases"]`` under ``tp_case``, the demos of ``jobs["demos"]``
    and the resume twins ``jobs["twins"]`` at the CLI's ``--platform``,
    on the card with PyTorch's deterministic algorithms (tabular Q's TD
    scatter adds floats with atomics there otherwise), each part's wall
    time. ``platform="cpu"`` runs the same on the CPU."""
    import time

    dev = torch.device("cpu")
    if platform == "cuda":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        dev = torch.device("cuda", 0)
    out, wall = {"rank": dist.get_rank()}, {}
    t0 = time.perf_counter()
    mesh12, _ = _meshes(dev)
    out["tp"] = {name: tp_case(case, mesh12, None) for name, case in jobs["cases"].items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall["tp"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["demos"] = demo_jobs(jobs["demos"], dev)
    wall["demos"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["resume"] = resume_jobs(jobs["twins"], workdir, platform)
    wall["resume"] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out


def card_phase(platform: str = "cuda", log=print, timeout: float = 600.0) -> dict:
    """``chip_smoke.py`` phase 10 (its docstring) on two gloo ranks sharing
    the card, or two CPU ranks: (a) ``TPTrainer`` at (D 1, M 2) against the
    unwrapped trainer on ``CARD_CASES`` within ``TP_TOL``, episodes
    bitwise; (b) the demos at 2 ranks against their single-process
    programs within atol 1e-5; (c) the resume twins of tabular-q and
    deep-q with PER, bitwise on each rank; (d) on the card, ``--n-devices 2
    --tp 2`` refused with the visible-card count. Raises
    ``AssertionError`` at a fault; returns the summary."""
    import tempfile
    import time

    from ..cli.main import run
    from ..parallel import launch

    t0 = time.perf_counter()
    demos = demo_cases(2)
    jobs = {"cases": CARD_CASES, "demos": demos, "twins": ["tabular", "dqn per"]}
    with tempfile.TemporaryDirectory(prefix="sga_phase10_") as work:
        ranks = launch.spawn(card_ranks, 2, (jobs, work, platform), backend="gloo",
                             timeout=timeout)
    # (a) TPTrainer at (D 1, M 2) against the unwrapped trainer, on each rank.
    tp = {f"{name} rank {r['rank']}": compare(rec["tp12"], rec["single"])
          for r in ranks for name, rec in r["tp"].items()}
    for key, c in tp.items():
        log(f"10a. {key}: {json.dumps(c)}")
    shapes = {name: rec["shapes"] for name, rec in ranks[0]["tp"].items()}
    # (b) the demos against their single-process programs.
    dev = torch.device("cuda", 0) if platform == "cuda" else torch.device("cpu")
    demo = demo_errors([r["demos"] for r in ranks], demo_reference(demos, dev))
    log(f"10b. demos, max abs errors at 2 ranks: {json.dumps(demo)}")
    # (c) the resume twins: each rank's final file bitwise the straight run's.
    fault = first_failure([r["resume"] for r in ranks])
    resume = {name: {"leaves": ranks[0]["resume"][name]["leaves"],
                     "layout": ranks[0]["resume"][name]["layout"],
                     "final": ranks[0]["resume"][name]["finals"]["straight"]}
              for name in jobs["twins"]}
    log(f"10c. resume twins at --n-devices 2: {json.dumps(resume)}  fault: {fault}")
    # (d) --n-devices 2 --tp 2 on one card: refused with the visible count.
    refusal = None
    if platform == "cuda":
        try:
            run(["island", "ppo-mlp", "--n-devices", "2", "--tp", "2"])
        except SystemExit as e:
            refusal = str(e.code)
    summary = {"tp_vs_unwrapped": tp, "shard_shapes": shapes, "demo_max_abs_err": demo,
               "resume": resume, "n_devices_2_tp_2_on_one_card": refusal,
               "rank_wall_s": [r["wall_s"] for r in ranks],
               "wall_s": time.perf_counter() - t0}
    assert all(c["ok"] for c in tp.values()), tp
    assert shapes["island"]["params/Dense_0.kernel"] == (288, 64), shapes
    assert shapes["sokoban"]["params/w1"] == (144, 64), shapes
    assert all(e <= 1e-5 for d in demo.values() for e in d.values()), demo
    assert fault is None, fault
    if platform == "cuda":
        assert refusal and "1 card(s) are visible" in refusal, refusal
    return summary


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="chip_smoke.py phase 10 alone")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    summary = card_phase(args.platform)
    if args.platform == "cuda":
        import subprocess

        summary["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
