"""Rollout kernel B1: the port's plain version ≡ the JAX Pallas kernel, bitwise.

The JAX kernel runs in Pallas interpret mode on the CPU, as its own tests
run it; the port's wrapper takes its plain version for CPU tensors. Every
output is exact (integer rewards, small counts), so all 8 per-lane outputs
must be equal, chunk after chunk.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.ops.rollout_kernel import PallasRolloutEngine  # noqa: E402
from safe_grid_agents_torch.convert import (  # noqa: E402
    engine_state_from_numpy, engine_state_to_numpy,
)
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.ops import rollout_kernel as rk  # noqa: E402

torch.set_num_threads(1)
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len",
         "reward_acc", "episode_acc", "finished_return_acc"]


def _engines(alias, n):
    eng = rk.RolloutEngine(make_env(alias, compiled=True, device="cpu"), n)
    jeng = PallasRolloutEngine(jax_compile(jax_make_env(alias)), n)
    assert eng.reset_idx == jeng.reset_idx
    return eng, jeng


def _assert_outs_equal(outs, jouts, tag):
    for port, ref, name in zip(outs, jouts, NAMES):
        ref = np.asarray(ref)
        port = port.numpy()
        assert port.dtype == ref.dtype, f"{tag} {name}"
        np.testing.assert_array_equal(port, ref, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("alias", ["shift", "shift-test"])
def test_rollout_plain_matches_pallas_kernel(alias):
    N, T = 256, 256
    eng, jeng = _engines(alias, N)
    actions = np.random.default_rng(7).integers(0, 4, (T, N)).astype(np.int32)
    rk.counts.reset()
    outs = eng.run_actions(eng.reset(), torch.from_numpy(actions))
    assert rk.counts.plain_calls == 1 and rk.counts.launches == 0
    jouts = jeng.run_actions(jeng.reset(), jnp.asarray(actions))
    _assert_outs_equal(outs, jouts, alias)
    assert float(outs[6].sum()) > N  # episodes ended inside the chunk


def test_rollout_chunks_compose_like_pallas_kernel():
    """Two chained chunks: the carried 5-tuple round-trips through both
    packages and every chunk's outputs agree."""
    N, T = 256, 256
    eng, jeng = _engines("shift", N)
    rng = np.random.default_rng(3)
    state, jstate = eng.reset(), jeng.reset()
    for chunk in range(2):
        actions = rng.integers(0, 4, (T, N)).astype(np.int32)
        outs = eng.run_actions(state, torch.from_numpy(actions))
        jouts = jeng.run_actions(jstate, jnp.asarray(actions))
        _assert_outs_equal(outs, jouts, f"chunk {chunk}")
        state, jstate = outs[:5], jouts[:5]
    # The port also resumes from the JAX state carried across as numpy.
    actions = rng.integers(0, 4, (T, N)).astype(np.int32)
    crossed = engine_state_from_numpy([np.asarray(x) for x in jstate], "cpu")
    _assert_outs_equal(eng.run_actions(crossed, torch.from_numpy(actions)),
                       jeng.run_actions(jstate, jnp.asarray(actions)), "crossed")
    assert all(a.dtype == np.asarray(b).dtype
               for a, b in zip(engine_state_to_numpy(crossed), jstate))


def test_run_random_reduced_totals():
    eng, _ = _engines("shift", 128)
    g = torch.Generator().manual_seed(0)
    state, acc = eng.run_random_reduced(eng.reset(), g, 300)
    g = torch.Generator().manual_seed(0)
    actions = torch.randint(0, 4, (300, 128), dtype=torch.int32, generator=g)
    outs = rk.rollout_reference(eng.tables, eng.reset(), actions)
    assert all(torch.equal(a, b) for a, b in zip(state, outs[:5]))
    assert float(acc["reward_sum"]) == float(outs[5].sum())
    assert int(acc["episodes"]) == int(outs[6].sum()) > 0
    assert float(acc["finished_return_sum"]) == float(outs[7].sum())


def test_rollout_wrapper_rejects_bad_inputs():
    eng, _ = _engines("shift", 8)
    state = eng.reset()
    with pytest.raises(ValueError, match="actions"):
        eng.run_actions(state, torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="state.idx"):
        eng.run_actions((state[0].long(),) + state[1:],
                        torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="actions"):
        eng.run_actions(state, torch.zeros((4, 8), dtype=torch.int32).t().contiguous().t())
