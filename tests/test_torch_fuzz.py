"""The cross-engine fuzz (``safe_grid_agents_torch/tools/fuzz.py``) and the
compiled engine's bench path (``envs/vec.py::VecEnv.run_random_reduced``),
on the CPU.

* The fuzz at ``--steps 64 --n-envs 32`` on every compileable alias: the
  array engine over the base env and over the compiled env agree bitwise on
  the same actions and draws; one table entry altered makes it exit
  non-zero naming alias, field and ``(t, env)``.
* ``VecEnv.run_random_reduced`` against the JAX ``MXUVecEnv.
  run_random_reduced`` on the same ``[T, N]`` action matrix: bitwise on the
  deterministic aliases (small-integer rewards: the float32 sums are exact);
  on the stochastic ones equal to the totals of the port's own
  ``run_actions`` on the same draws (the JAX engine's per-lane keys draw
  other numbers).
"""
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.tools import fuzz  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
DETERMINISTIC = ["shift", "shift-test", "island", "sokoban", "boat", "conveyor",
                 "conveyor-sushi", "corners", "way", "toy"]
STOCHASTIC = ["absent", "interrupt", "whisky", "tomato", "friend"]
N, T = 64, 130  # T crosses the 100-step timeout


@pytest.mark.parametrize("alias", fuzz.COMPILEABLE)
def test_fuzz_pair_is_bitwise_on_every_compileable_alias(alias):
    steps, bad = fuzz.run_pair(alias, 64, 32, 0, CPU)
    assert bad is None, bad
    assert steps == 64


def test_fuzz_cli_prints_the_reference_lines(capsys, monkeypatch):
    monkeypatch.setattr(fuzz, "COMPILEABLE", ["shift", "whisky", "friend"])
    total = fuzz.main(["--steps", "64", "--n-envs", "32", "--platform", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[:3] == [f"{a:16s} OK  (2,048 transitions)" for a in ("shift", "whisky",
                                                                     "friend")]
    assert out[-1] == "all 3 aliases bitwise-identical over 6,144 transitions"
    assert total == 3 * 64 * 32


@pytest.mark.parametrize("alias,table,field", [
    ("shift", "reward_table", "reward"),
    ("whisky", "hidden_table", "hidden_reward"),
    ("absent", "done_table", "done"),
])
def test_fuzz_names_an_altered_table_entry(monkeypatch, alias, table, field):
    """One entry of the compiled table altered (the first reset state's row
    under action 0): the fuzz exits non-zero naming alias, field and the
    first ``(t, env)`` where that entry is read."""
    cenv = make_env(alias, compiled=True, device=CPU)
    start = int(cenv.reset_from_coin(torch.zeros(1, dtype=torch.int32)).idx[0]) \
        if hasattr(cenv.base, "reset_from_coin") else int(cenv.reset(1).idx[0])
    tab = getattr(cenv, table)
    tab[start, 0] = ~tab[start, 0] if tab.dtype == torch.bool else tab[start, 0] + 7
    monkeypatch.setattr(fuzz, "compiled_env", lambda a, d: cenv)
    monkeypatch.setattr(fuzz, "COMPILEABLE", [alias])
    with pytest.raises(SystemExit) as e:
        fuzz.main(["--steps", "64", "--n-envs", "32", "--platform", "cpu"])
    msg = str(e.value.code)
    m = re.fullmatch(rf"MISMATCH {alias}\.{field} at \(t, env\)=\((\d+), (\d+)\): "
                     r"base (\S+) compiled (\S+)", msg)
    assert m, msg
    # The reported transition is one that reads the altered entry: a lane
    # in the start state choosing action 0.
    t, env = int(m.group(1)), int(m.group(2))
    g = torch.Generator().manual_seed(0)
    vb = fuzz.ArrayVecEnv(make_env(alias), 32, CPU)
    coin = fuzz.grid.coins(32, g, CPU).to(torch.int32) if vb.coin_reset else None
    actions = torch.randint(0, cenv.n_actions, (64, 32), dtype=torch.int32, generator=g)
    assert int(actions[t, env]) == 0
    if t == 0 and coin is not None:
        assert int(coin[env]) == 0


def _jax_actions(key, T, n, A):
    return np.asarray(jax.random.randint(key, (T, n), 0, A))


@pytest.mark.parametrize("alias", DETERMINISTIC)
def test_run_random_reduced_matches_jax_bitwise(alias):
    cenv = make_env(alias, compiled=True, device=CPU)
    vec, jvec = VecEnv(cenv, N), MXUVecEnv(jax_make_env(alias, compiled=True), N)
    key = jax.random.PRNGKey(9)
    _, jacc = jax.jit(jvec.run_random_reduced, static_argnums=2)(
        jvec.reset(jax.random.PRNGKey(5)), key, T)
    acts = torch.from_numpy(_jax_actions(key, T, N, cenv.n_actions).astype(np.int32))
    _, acc = vec.run_random_reduced(vec.reset(), None, T, actions=acts)
    for k in ("reward_sum", "episodes", "finished_return_sum"):
        got, want = acc[k].numpy(), np.asarray(jacc[k])
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert int(acc["episodes"]) > 0


@pytest.mark.parametrize("alias", STOCHASTIC)
def test_run_random_reduced_equals_its_own_run_actions_totals(alias):
    kw = {"cap": 15} if alias == "friend" else {}
    vec = VecEnv(make_env(alias, compiled=True, device=CPU, **kw), N)
    vs = vec.reset(torch.Generator().manual_seed(5))
    _, acc = vec.run_random_reduced(vs, torch.Generator().manual_seed(9), T)
    g = torch.Generator().manual_seed(9)
    acts = torch.randint(0, vec.A, (T, N), dtype=torch.int32, generator=g)
    _, outs = vec.run_actions(vs, acts, vec.draw_mechanics(g, T))
    d = outs["done"]
    want = {"reward_sum": outs["reward"].sum(0).sum(), "episodes": d.sum(dtype=torch.int32),
            "finished_return_sum": torch.where(d, outs["finished_return"], 0.0).sum()}
    for k, v in want.items():
        assert acc[k].dtype == v.dtype and torch.equal(acc[k], v), (k, acc[k], v)
    assert int(acc["episodes"]) > 0
