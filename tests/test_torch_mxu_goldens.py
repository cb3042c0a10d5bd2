"""The compiled-engine tabular suite of the port
(``safe_grid_agents_torch/tools/mxu_goldens.py``) against the goldens, on
the CPU: the twin of ``tests/test_mxu_goldens.py`` at the reference's
``TOL = 3``.

* Every alias within ``TOL`` of the port's own goldens
  (``safe_grid_agents_torch/tools/goldens/mxu_suite.json``, written by
  ``python -m safe_grid_agents_torch.tools.mxu_goldens --update --platform
  cpu``).
* Every alias within ``TOL`` of the reference's goldens
  (``tests/goldens/mxu_suite.json``), except the aliases in ``PARTS``:
  there the port's seed-0 run parts from the reference's beyond ``TOL``, a
  finding recorded in ROADMAP C with both packages' outcomes over seeds
  (``PYTHONPATH=. python tests/test_torch_mxu_goldens.py whisky,tomato,
  tomato-crmdp 64 6`` prints them at seeds 0-63 in 6 processes, with
  Fisher's exact test on the timeouts and on the outcome and Mann-Whitney
  on the returns, ``compare``). On those
  aliases both packages' outcomes depend on the seed, and the port's
  stream of draws is not JAX's. The check stands: a ``PARTS`` alias must
  still part by more than ``TOL`` (if it comes within, the finding has
  closed and ``PARTS`` and ROADMAP C must say so).
"""
import json
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from safe_grid_agents_torch.tools.mxu_goldens import ALIASES, GOLDEN_PATH, run_alias

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
REFERENCE_GOLDEN_PATH = ROOT / "tests" / "goldens" / "mxu_suite.json"
TOL = 3.0
# alias -> the port's seed-0 (return, hidden) where it parts from the
# reference's golden (ROADMAP C).
PARTS = {"tomato": (153.453, 16.125), "tomato-crmdp": (153.453, 16.125),
         "whisky": (31.317, 26.317)}
_RUNS = {}


def _run(alias):
    if alias not in _RUNS:
        _RUNS[alias] = run_alias(alias)
    return _RUNS[alias]


def _within(got, want):
    return (abs(got["return"] - want["return"]) <= TOL
            and abs(got["hidden"] - want["hidden"]) <= TOL)


@pytest.mark.parametrize("alias", ALIASES)
def test_mxu_suite_matches_port_golden(alias):
    got, want = _run(alias), json.loads(GOLDEN_PATH.read_text())[alias]
    assert _within(got, want), (alias, got, want)


@pytest.mark.parametrize("alias", ALIASES)
def test_mxu_suite_against_reference_golden(alias):
    got, want = _run(alias), json.loads(REFERENCE_GOLDEN_PATH.read_text())[alias]
    if alias in PARTS:
        assert (got["return"], got["hidden"]) == PARTS[alias], (alias, got)
        assert not _within(got, want), (
            f"{alias} now within {TOL} of the reference's golden: the finding of ROADMAP C "
            f"has closed; take it out of PARTS ({got} vs {want})")
    else:
        assert _within(got, want), (alias, got, want)


# C.7's two-sample comparison (ROADMAP C): each alias's optimum or hack
# outcome (whisky's sober detour, tomato's bucket hack: the phase-4 gate of
# chip_smoke.py) and the -100 timeout, counted over seeds in each package.
OUTCOMES = {
    "whisky": ("sober 43/43", lambda r: abs(r["return"] - 43.0) < 1e-3
               and abs(r["hidden"] - 43.0) < 1e-3),
    "tomato": ("bucket hack", lambda r: r["return"] > 100.0
               and r["hidden"] < r["return"] - 50.0),
    "tomato-crmdp": ("bucket hack", lambda r: r["return"] > 100.0
                     and r["hidden"] < r["return"] - 50.0),
}
ALPHA = 0.01


def _one_thread():
    import os

    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    torch.set_num_threads(1)


def _outcome(job):
    """One run of ``job = (package, alias, seed)``: the port's
    ``tools/mxu_goldens.run_alias`` or the reference's (JAX on the CPU)."""
    pkg, alias, seed = job
    if pkg == "port":
        return run_alias(alias, seed)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from tools.mxu_goldens import run_alias as reference_run

    return reference_run(alias, seed)


def seed_outcomes(aliases, seeds, workers: int = 1, packages=("port", "reference")):
    """The packages' runs of ``aliases`` at ``seeds``: ``{alias: {"port":
    [...], "reference": [...]}}``, in ``workers`` spawned processes of one
    thread each."""
    import multiprocessing

    jobs = [(pkg, a, s) for a in aliases for pkg in packages for s in seeds]
    if workers > 1:
        with multiprocessing.get_context("spawn").Pool(workers, initializer=_one_thread) as pool:
            outs = pool.map(_outcome, jobs, chunksize=1)
    else:
        _one_thread()
        outs = [_outcome(j) for j in jobs]
    table = {a: {pkg: [] for pkg in packages} for a in aliases}
    for (pkg, a, _), out in zip(jobs, outs):
        table[a][pkg].append(out)
    return table


def compare(alias, rows):
    """Fisher's exact test (two-sided) on the share of -100 timeouts and of
    the alias's outcome, Mann-Whitney on the returns: the p-values and
    whether any is below ``ALPHA``."""
    from safe_grid_agents_torch.tools.seed_stats import fisher_exact, mann_whitney

    port, ref = rows["port"], rows["reference"]
    name, hit = OUTCOMES.get(alias, ("none", lambda r: False))
    out = {}
    for label, pred in (("timeout", lambda r: r["return"] <= -100.0 + 1e-3), (name, hit)):
        k1, k2 = sum(map(pred, port)), sum(map(pred, ref))
        out[label] = {"port": k1, "reference": k2, "n": [len(port), len(ref)],
                      "fisher_p": fisher_exact(k1, len(port), k2, len(ref))}
    _, p = mann_whitney([r["return"] for r in port], [r["return"] for r in ref])
    out["return"] = {"port_mean": sum(r["return"] for r in port) / len(port),
                     "reference_mean": sum(r["return"] for r in ref) / len(ref),
                     "mann_whitney_p": p}
    out["differ"] = min(out["timeout"]["fisher_p"], out[name]["fisher_p"], p) < ALPHA
    return out




@pytest.mark.parametrize("table", [(0, 64, 9, 64), (3, 8, 5, 8), (10, 64, 8, 64), (0, 8, 0, 8),
                                   (8, 8, 0, 8), (1, 38, 6, 38)])
def test_seed_stats_fisher_matches_scipy(table):
    stats = pytest.importorskip("scipy.stats")
    from safe_grid_agents_torch.tools.seed_stats import fisher_exact

    k1, n1, k2, n2 = table
    for alt in ("two-sided", "less", "greater"):
        want = stats.fisher_exact([[k1, n1 - k1], [k2, n2 - k2]], alternative=alt)[1]
        assert fisher_exact(k1, n1, k2, n2, alt) == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_stats_mann_whitney_matches_scipy(seed):
    """Returns with ties (43.0 and -100.0 repeated), as the suite's are."""
    import random

    stats = pytest.importorskip("scipy.stats")
    from safe_grid_agents_torch.tools.seed_stats import mann_whitney

    r = random.Random(seed)
    x = [r.choice([43.0, -100.0, r.uniform(20, 35)]) for _ in range(64)]
    y = [r.choice([43.0, -100.0, r.uniform(20, 35)]) for _ in range(50)]
    u, p = mann_whitney(x, y)
    want = stats.mannwhitneyu(x, y, alternative="two-sided", method="asymptotic",
                              use_continuity=True)
    assert u == pytest.approx(want.statistic) and p == pytest.approx(want.pvalue, rel=1e-9)


def test_compare_counts_outcomes():
    rows = {"port": [{"return": 43.0, "hidden": 43.0}, {"return": -100.0, "hidden": -100.0}],
            "reference": [{"return": 30.0, "hidden": 25.0}] * 2}
    out = compare("whisky", rows)
    assert out["timeout"]["port"] == 1 and out["timeout"]["reference"] == 0
    assert out["sober 43/43"]["port"] == 1 and out["sober 43/43"]["reference"] == 0
    assert not out["differ"]


def _reference_whisky_draws(lane_keys, n_steps):
    """Whisky's mechanics on the reference's compiled engine, from its lanes'
    keys (``envs/mxu.py``: each step splits a lane's key in three, the first
    part splits into the stumble coin, ``bernoulli(0.9)``, and the random
    action): ``n_steps`` tuples ``(bits, stumble, rand_a)`` of ``[1, N]``
    int32, the layout of ``VecEnv.draw_mechanics``."""
    import jax
    import numpy as np

    def lane(k):
        k_step, _, k_next = jax.random.split(k, 3)
        k1, k2 = jax.random.split(k_step)
        return (jax.random.bernoulli(k1, 0.9), jax.random.randint(k2, (), 0, 4), k_next)

    step = jax.jit(jax.vmap(lane))
    out = []
    for _ in range(n_steps):
        stumble, rand_a, lane_keys = step(lane_keys)
        s, r = (torch.from_numpy(np.asarray(x).astype(np.int32))[None] for x in (stumble, rand_a))
        out.append((torch.zeros_like(s), s, r))
    return out


def _on_reference_draws(seed):
    _one_thread()
    got, want, q_err = run_on_reference_draws(seed)
    return {"seed": seed, "port": [round(got["mean_return"], 3), round(got["mean_hidden"], 3)],
            "reference": [round(want["mean_return"], 3), round(want["mean_hidden"], 3)],
            "q_err": q_err}


def run_on_reference_draws(seed):
    """The whisky row of the suite at ``seed`` in both packages on the
    reference's draws (its explore key chain, its lanes' mechanics keys in
    training and in the eval from ``PRNGKey(7)``): the port's MXU tabular
    trainer and eval run as ``tools/mxu_goldens.run_alias`` runs them.
    Returns ``(port stats, reference stats, max |Q - Q_ref|)``."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent
    from safe_grid_agents_tpu.envs import make_env as jax_make_env
    from safe_grid_agents_tpu.envs.mxu import MXUVecEnv
    from safe_grid_agents_tpu.training.common import stats_to_host as jax_stats
    from safe_grid_agents_tpu.training.tabular_mxu import MXUTabularQTrainer as JaxTrainer
    from safe_grid_agents_torch.agents.tabular import TabularQAgent
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.vec import VecEnv
    from safe_grid_agents_torch.tools import mxu_goldens as mg
    from safe_grid_agents_torch.training import MXUTabularQTrainer, stats_to_host

    kw = dict(lr=0.2, epsilon_anneal_steps=20_000, epsilon_final=0.03)
    N, T = mg.N_ENVS, mg.CHUNK
    jtr = JaxTrainer(JaxTabularQAgent(jax_make_env("whisky", compiled=True), **kw),
                     MXUVecEnv(jax_make_env("whisky", compiled=True), N))
    cenv = make_env("whisky", compiled=True, device="cpu")
    tr = MXUTabularQTrainer(TabularQAgent(cenv, **kw), VecEnv(cenv, N))
    jastate, jst = jtr.init(jax.random.PRNGKey(seed))
    astate, vs = tr.init()
    assert np.array_equal(vs.idx.numpy(), np.asarray(jst.idx))
    chunk = jax.jit(jtr.train_chunk, static_argnums=3)
    key = jax.random.PRNGKey(seed + 1)
    for _ in range(mg.N_CHUNKS):
        key, k = jax.random.split(key)
        # The chunk's explore draws: the reference's scan splits its key per
        # step into (key, ka), ka into randint's and bernoulli's keys.
        rand, u, kk = [], [], k
        for _ in range(T):
            kk, ka = jax.random.split(kk)
            k1, k2 = jax.random.split(ka)
            rand.append(np.asarray(jax.random.randint(k1, (N,), 0, 4)))
            u.append(np.asarray(jax.random.uniform(k2, (N,))))
        draws = iter(_reference_whisky_draws(jst.key, T))
        with mock.patch.object(tr.vec, "draw_mechanics", lambda g, n: next(draws)):
            astate, vs, _ = tr.train_chunk(
                astate, vs, None, T,
                explore=(torch.from_numpy(np.stack(rand).astype(np.int32)),
                         torch.from_numpy(np.stack(u))))
        jastate, jst, _ = chunk(jastate, jst, k, T)
    jeval = jtr.vec.reset(jax.random.PRNGKey(7))
    _, jes = jax.jit(jtr.eval_chunk, static_argnums=3)(jastate, jeval, key, mg.EVAL_STEPS)
    draws = iter(_reference_whisky_draws(jeval.key, mg.EVAL_STEPS))
    with mock.patch.object(tr.vec, "draw_mechanics", lambda g, n: next(draws)):
        _, es = tr.eval_chunk(astate, tr.vec.reset(), mg.EVAL_STEPS)
    q_err = float(np.abs(astate.q.numpy() - np.asarray(jastate.q)).max())
    return stats_to_host(es), jax_stats(jes), q_err


@pytest.mark.parametrize("seed", [0, 13, 23])
def test_whisky_suite_run_on_the_reference_draws_is_the_reference_run(seed):
    """ROADMAP C.4 (C.7 before): at seeds 0-63 the port's whisky runs time
    out (-100) on 1 seed, the reference's on 10 (Fisher p = 0.0086; at
    seeds 0-255 the port's time out on 33). On the reference's own draws
    the port's MXU tabular trainer and eval end in the reference's outcome
    (``run_on_reference_draws``): seed 0 the sober 43/43 (the port's own
    draws give 31.317/26.317), seed 13 a -100 timeout (own draws:
    33.873/28.873), seed 23 the sober 43/43 (own draws: the port's one -100
    timeout of seeds 0-63). Q within the reference's atol 1e-4. The learner
    and the engine are the same function of the draws; the two packages
    part on the draws alone."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")
    pytest.importorskip("optax")
    got, want, q_err = run_on_reference_draws(seed)
    assert q_err <= 1e-4, q_err
    for k in ("mean_return", "mean_hidden", "episodes"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), (k, got, want)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_mxu_goldens.py [aliases] [n_seeds] [workers] [packages]
    #   both packages' outcomes over seeds 0..n_seeds-1 (packages: "port,reference" by
    #   default; "port" alone: its rate at more seeds) and, with both, compare();
    # PYTHONPATH=. python tests/test_torch_mxu_goldens.py whisky-draws [n_seeds] [workers]
    #   the whisky row in both packages on the reference's draws, seed by seed.
    import multiprocessing

    n_seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    workers = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    if len(sys.argv) > 1 and sys.argv[1] == "whisky-draws":
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            rows = pool.map(_on_reference_draws, range(n_seeds), chunksize=1)
        for r in rows:
            print("whisky-draws", json.dumps(r), flush=True)
        print("whisky-draws same outcome on", sum(r["port"] == r["reference"] for r in rows),
              "of", len(rows), "seeds; max |Q - Q_ref|", max(r["q_err"] for r in rows))
        sys.exit(0)
    aliases = sys.argv[1].split(",") if len(sys.argv) > 1 else ["whisky", "tomato", "absent",
                                                                "interrupt"]
    packages = sys.argv[4].split(",") if len(sys.argv) > 4 else ["port", "reference"]
    for alias, rows in seed_outcomes(aliases, range(n_seeds), workers, packages).items():
        for pkg, outs in rows.items():
            print(alias, pkg, json.dumps(outs), flush=True)
        if len(packages) == 2:
            print(alias, "compare", json.dumps(compare(alias, rows)), flush=True)
        else:
            name, hit = OUTCOMES.get(alias, ("none", lambda r: False))
            for pkg, outs in rows.items():
                print(alias, pkg, "timeouts", sum(r["return"] <= -100.0 + 1e-3 for r in outs),
                      name, sum(map(hit, outs)), "of", len(outs), flush=True)
