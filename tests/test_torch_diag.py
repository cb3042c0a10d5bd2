"""The port's decompositions (``safe_grid_agents_torch/tools/diag.py``) on
the CPU, at toy sizes: each of the nine subcommands runs with ``--platform
cpu``, prints the reference's row labels (``tools/diag.py``) and states
that no time is a device time; ``engine-pallas`` and ``engine-stoch`` hold
the kernel engines' plain versions to the compiled engine on the same
generator state (lanes and totals), ``engine-carry`` the carry engine's
reward totals to it, and ``ppo-kernel-opt`` B6's plain version to the
autograd optimize."""
import json

import pytest
import torch

from safe_grid_agents_torch.tools import diag

torch.set_num_threads(1)

CASES = {
    "engine-pallas": (["--t", "64", "--lanes", "16"], ["xla-mxu N=16", "pallas  N=16"]),
    "engine-stoch": (["--t", "48", "--lanes", "16"],
                     [f"{a} {k} N=16" for a in ("absent", "interrupt", "whisky", "friend",
                                                 "tomato")
                      for k in ("xla-mxu", "kernel ")]),
    "engine-carry": (["--t", "40", "--lanes", "16"],
                     ["construct N=16", "carry     N=16 (dtype=float32)"]),
    "ppo-decomp": (["--n-envs", "8", "--t", "16"],
                   ["chunk/full", "collect/vec", "collect/mxu", "opt/full",
                    "opt/fixed-minibatch", "opt/gradonly", "perm only", "gather only"]),
    "ppo-candidates": (["--n-envs", "8"],
                       ["collect T=8 unroll=1", "opt T=8 envslice", "opt T=8 envslice flat",
                        "opt T=16 envslice flat"]),
    "ppo-e2e": (["--n-envs", "4"],
                ["fast chunk T=8", "fast chunk T=16", "superchunk K=2 T=8",
                 "superchunk K=4 T=8", "superchunk K=2 T=16"]),
    "ppo-lanes": (["--t", "4", "--k", "2", "--lanes", "8", "16"],
                  ["N=8 T=4 K=2 mb=2", "N=16 T=4 K=2 mb=4"]),
    "dqn-decomp": (["--n-envs", "8", "--t", "16"],
                   ["chunk/full T=16 U=2", "collect+push T=16", "collect/nopush T=16",
                    "updates U=2 (base pytree)", "sample only xU", "td fwd+bwd only xU",
                    "adam only xU (pytree)", "chunk/flat unroll=1", "superchunk K=8"]),
    "ppo-kernel-opt": (["--n-envs", "8", "--t", "16"],
                       ["xla fast optimize (16 updates)",
                        "fused kernel optimize (16 updates)"]),
}


@pytest.mark.parametrize("cmd", sorted(CASES))
def test_subcommand_prints_the_reference_rows(cmd, capsys, tmp_path):
    flags, labels = CASES[cmd]
    out = tmp_path / "rows.json"
    rows = diag.main([cmd, "--platform", "cpu", "--out", str(out)] + flags)
    err = capsys.readouterr().err
    assert "no time here is a device time" in err.splitlines()[0]
    printed = [r["label"] for r in rows if "label" in r]
    for label in labels:
        assert label in printed, (label, printed)
        assert any(l.startswith(label) and " ms  (min " in l for l in err.splitlines()), label
    assert all(r["ms"] >= 0 for r in rows if "label" in r and "min_ms" in r)
    assert all(r["calls"] >= 5 for r in rows if "calls" in r)
    assert json.loads(out.read_text())["rows"] == rows
    checks = [r for r in rows if "check" in r]
    assert all(c["equal"] for c in checks), checks
    if cmd in ("engine-pallas", "engine-stoch", "engine-carry", "ppo-kernel-opt"):
        assert checks
    if cmd in ("ppo-candidates", "dqn-decomp"):
        assert any("no counterpart in eager PyTorch" in r.get("note", "") for r in rows)


@pytest.mark.parametrize("alias", ["absent", "whisky", "tomato", "friend"])
def test_engine_stoch_totals_equal_on_the_same_generator_state(alias):
    """B7's plain version and the compiled engine from the same generator
    state: the kernel engine's protocol (actions, then the mechanics) gives
    both the same draws, so every lane's sums and the totals agree, and the
    run_random_reduced totals themselves are equal (small sums: exact)."""
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.vec import VecEnv
    from safe_grid_agents_torch.ops.stoch_rollout_kernel import StochRolloutEngine

    kw = {"cap": 15} if alias == "friend" else {}
    cenv = make_env(alias, compiled=True, device="cpu", **kw)
    vec, ker = VecEnv(cenv, 24), StochRolloutEngine(cenv, 24)
    g = torch.Generator().manual_seed
    _, a = vec.run_random_reduced(vec.reset(g(0)), g(1), 150)
    _, b = ker.run_random_reduced(ker.reset(g(0)), g(1), 150)
    for k in ("reward_sum", "episodes", "finished_return_sum"):
        assert torch.equal(a[k], b[k]), (k, a[k], b[k])
    assert int(a["episodes"]) > 0


def test_engine_pallas_totals_equal_on_the_same_generator_state():
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.vec import VecEnv
    from safe_grid_agents_torch.ops.rollout_kernel import RolloutEngine

    cenv = make_env("shift", compiled=True, device="cpu")
    vec, ker = VecEnv(cenv, 24), RolloutEngine(cenv, 24)
    g = torch.Generator().manual_seed
    _, a = vec.run_random_reduced(vec.reset(), g(1), 150)
    _, b = ker.run_random_reduced(ker.reset(), g(1), 150)
    for k in ("reward_sum", "episodes", "finished_return_sum"):
        assert torch.equal(a[k], b[k]), (k, a[k], b[k])
    assert int(a["episodes"]) > 0
