"""The sharded rollout engines (B1 and B7 split over the lanes of a data
group) against the JAX package's ``shard_map`` engines and the port's own
single engines.

The port's side runs in W spawned gloo ranks on the CPU
(``parallel.launch.spawn``; W = 2 and 4, one spawn each, 120 s join timeout
each), where each rank's wrapper takes the kernel's plain version. The JAX
side runs ``ShardedPallasRolloutEngine`` and
``ShardedPallasStochRolloutEngine`` on a mesh of W of the conftest's 8 CPU
devices, in Pallas interpret mode as ``tests/test_rollout_kernel.py:108``
and ``tests/test_stoch_rollout_kernel.py:133`` run them. Both take the same
global actions (B1 on shift) and streams (B7 on whisky, tomato and absent),
drawn with numpy, from the same mid-episode state. Every per-lane output
must be bitwise equal, on every rank after its gather. The reduced
protocol's totals are held to the single engine's bitwise: the episode
count is an integer, and the float sums are sums of multiples of 0.5 far
below 2²⁴, exact in any association.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.ops.rollout_kernel import ShardedPallasRolloutEngine  # noqa: E402
from safe_grid_agents_tpu.ops.stoch_rollout_kernel import (  # noqa: E402
    ShardedPallasStochRolloutEngine,
)
from safe_grid_agents_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import rollout_kernel as rk  # noqa: E402
from safe_grid_agents_torch.ops import stoch_rollout_kernel as srk  # noqa: E402
from safe_grid_agents_torch.parallel import launch  # noqa: E402
from safe_grid_agents_torch.parallel.mesh import DataGroup  # noqa: E402
from safe_grid_agents_torch.tools import dp_cases  # noqa: E402

torch.set_num_threads(1)
N, T = 64, 32
B7_ALIASES = ("whisky", "tomato", "absent")
TIMEOUT = 120  # seconds for one spawn of W ranks
NAMES = ["idx", "t", "ep_return", "ep_hidden", "ep_len",
         "reward_acc", "episode_acc", "finished_return_acc"]


def _mid_state(cenv, rng):
    """A global mid-episode state, ``(1, N)`` each, numpy."""
    return (rng.choice(cenv.reachable.numpy(), (1, N)).astype(np.int32),
            rng.integers(0, int(cenv.max_steps), (1, N)).astype(np.int32),
            rng.integers(-30, 5, (1, N)).astype(np.float32),
            rng.integers(-30, 5, (1, N)).astype(np.float32),
            rng.integers(0, 60, (1, N)).astype(np.int32))


def _streams(vec, rng):
    """actions, bits (tomato's packed dry coins, else reset coins),
    stumble, rand_a: ``[T, N]`` int32 each."""
    actions = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    if vec.dry_nbits:
        dry = rng.random((T, N, vec.dry_nbits)) < 0.05
        bits = (dry.astype(np.int32) << np.arange(vec.dry_nbits)).sum(-1).astype(np.int32)
    else:
        bits = rng.integers(0, 2, (T, N)).astype(np.int32)
    stumble = (rng.random((T, N)) < 0.9).astype(np.int32)
    rand_a = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    return actions, bits, stumble, rand_a


def _cases():
    rng = np.random.default_rng(17)
    shift = make_env("shift", compiled=True, device="cpu")
    b1 = [dict(alias="shift", n=N, state=_mid_state(shift, rng),
               actions=rng.integers(0, shift.n_actions, (T, N)).astype(np.int32))]
    b7 = []
    for alias in B7_ALIASES:
        cenv = make_env(alias, compiled=True, device="cpu")
        b7.append(dict(alias=alias, n=N, state=_mid_state(cenv, rng),
                       streams=_streams(VecEnv(cenv, N), rng)))
    return {"b1": b1, "b7": b7}


def _jax_outputs(cases, W):
    mesh = jax_make_mesh(n_data=W, devices=jax.devices()[:W])
    out = {}
    for c in cases["b1"]:
        eng = ShardedPallasRolloutEngine(jax_make_env(c["alias"], compiled=True), N, mesh)
        out[c["alias"]] = jax.jit(eng.run_actions)(tuple(map(jnp.asarray, c["state"])),
                                                   jnp.asarray(c["actions"]))
    for c in cases["b7"]:
        eng = ShardedPallasStochRolloutEngine(jax_make_env(c["alias"], compiled=True), N, mesh)
        out[c["alias"]] = jax.jit(eng.run_streams)(tuple(map(jnp.asarray, c["state"])),
                                                   *map(jnp.asarray, c["streams"]))
    return {k: [np.asarray(x) for x in v] for k, v in out.items()}


def _single_outputs(cases):
    out = {}
    for c in cases["b1"]:
        eng = rk.RolloutEngine(make_env(c["alias"], compiled=True, device="cpu"), N)
        out[c["alias"]] = eng.run_actions(tuple(map(torch.from_numpy, c["state"])),
                                          torch.from_numpy(c["actions"]))
    for c in cases["b7"]:
        eng = srk.StochRolloutEngine(make_env(c["alias"], compiled=True, device="cpu"), N)
        out[c["alias"]] = eng.run_streams(tuple(map(torch.from_numpy, c["state"])),
                                          *map(torch.from_numpy, c["streams"]))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"W{w}")
def world(request):
    W = request.param
    cases = _cases()
    ranks = launch.spawn(dp_cases.sharded, W, (cases,), timeout=TIMEOUT)
    assert [r["rank"] for r in ranks] == list(range(W))
    return dict(W=W, cases=cases, ranks=ranks, jax=_jax_outputs(cases, W),
                single=_single_outputs(cases))


def _check_lanes(world, kind, alias):
    want_jax, want_single = world["jax"][alias], world["single"][alias]
    for r in world["ranks"]:
        got = r[kind][alias]
        for g, j, s, name in zip(got, want_jax, want_single, NAMES):
            assert g.dtype == s.dtype and g.shape == (1, N), (alias, name)
            np.testing.assert_array_equal(g.numpy(), j, err_msg=f"{alias} {name} vs JAX")
            assert torch.equal(g, s), f"{alias} {name} vs the single engine"


def test_sharded_b1_matches_jax_and_the_single_engine(world):
    _check_lanes(world, "b1", "shift")


@pytest.mark.parametrize("alias", B7_ALIASES)
def test_sharded_b7_matches_jax_and_the_single_engine(world, alias):
    _check_lanes(world, "b7", alias)


def test_sharded_totals_match_the_single_engine(world):
    """Every rank's all-reduced totals equal the single engine's on the
    same generator seed (the same global draw), bitwise."""
    for alias in ("shift",) + B7_ALIASES:
        want = dp_cases.single_engine_totals(alias, N, T)["totals"]
        assert float(want["reward_sum"]) != 0.0, alias
        for r in world["ranks"]:
            got = r["totals"][alias]
            for k in want:
                assert got[k].dtype == want[k].dtype, (alias, k)
                assert torch.equal(got[k], want[k]), (alias, k, got[k], want[k])


def test_sharded_b7_reset_draws_globally(world):
    """The coin reset is drawn for all N lanes and sliced: made whole, it is
    the single engine's reset from the same generator seed."""
    want = dp_cases.single_engine_totals("absent", N, T)["reset"]
    assert len(set(want[0].flatten().tolist())) == 2  # both coins came up
    for r in world["ranks"]:
        for g, w in zip(r["reset"]["absent"], want):
            assert torch.equal(g, w)


def test_sharded_engines_need_the_lanes_to_split():
    group = DataGroup(group=None, world_size=3, rank=0, device=torch.device("cpu"),
                      backend="gloo")
    with pytest.raises(ValueError, match="do not split"):
        rk.ShardedRolloutEngine(make_env("shift", compiled=True, device="cpu"), 64, group)
    with pytest.raises(ValueError, match="do not split"):
        srk.ShardedStochRolloutEngine(make_env("whisky", compiled=True, device="cpu"), 64,
                                      group)
    assert group.lanes(66) == slice(0, 22)
