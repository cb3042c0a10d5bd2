"""B1, B2, B3 and B5 on conveyor, whose tables do not fit one block's shared
memory: the kernels' device-memory placement, pinned here through the
plain versions it is held to on the card.

The plain versions run against the reference's Pallas kernels (interpret
mode on the CPU, as the JAX package's own tests run them) on conveyor, at
the reference's lane blocks there, on the reference's protocol with the
same numpy draws: B1 bitwise at N = 128; B2 at N = 64, Q within atol 1e-4
(``tests/test_tabular_kernel.py:91``) and every other output bitwise; B3
and B5 bitwise at N = 128. The wrappers' placement choice and their
device-memory layouts are checked for every deterministic alias.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.dqn import DQNAgent as JaxDQNAgent  # noqa: E402
from safe_grid_agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent  # noqa: E402
from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.dqn_kernel import dqn_collect_run  # noqa: E402
from safe_grid_agents_tpu.ops.ppo_collect_kernel import ppo_collect_run  # noqa: E402
from safe_grid_agents_tpu.ops.rollout_kernel import PallasRolloutEngine  # noqa: E402
from safe_grid_agents_tpu.ops.tabular_kernel import tabq_run  # noqa: E402
from safe_grid_agents_tpu.training.dqn_pallas import PallasDQNTrainer  # noqa: E402
from safe_grid_agents_tpu.training.ppo_pallas import PallasPPOTrainer  # noqa: E402
from safe_grid_agents_tpu.training.tabular_pallas import PallasTabularQTrainer  # noqa: E402
from safe_grid_agents_torch import convert  # noqa: E402
from safe_grid_agents_torch.agents.tabular import TabularQAgent  # noqa: E402
from safe_grid_agents_torch.envs import ENV_REGISTRY, make_env  # noqa: E402
from safe_grid_agents_torch.envs.sokoban import Sokoban  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import dqn_kernel as dk  # noqa: E402
from safe_grid_agents_torch.ops import ppo_collect_kernel as pck  # noqa: E402
from safe_grid_agents_torch.ops import rollout_kernel as rk  # noqa: E402
from safe_grid_agents_torch.ops import tabular_kernel as tk  # noqa: E402
from safe_grid_agents_torch.ops.rollout_kernel import SMEM_CAP, Tables  # noqa: E402
from safe_grid_agents_torch.training import FusedTabularQTrainer  # noqa: E402
from test_torch_ppo import _payload_rows  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conveyor():
    """The port's compiled conveyor and the JAX package's."""
    return make_env("conveyor", compiled=True, device="cpu"), jax_compile(
        jax_make_env("conveyor"))


def _lanes(rng, cenv, n, start, reset_idx):
    if start == "reset":
        return (np.full(n, reset_idx, np.int32), np.zeros(n, np.int32),
                np.zeros(n, np.float32), np.zeros(n, np.float32), np.zeros(n, np.int32))
    return (rng.choice(cenv.reachable.numpy(), n).astype(np.int32),
            rng.integers(0, 50, n).astype(np.int32),
            rng.integers(-10, 2, n).astype(np.float32),
            rng.integers(-10, 2, n).astype(np.float32), rng.integers(0, 40, n).astype(np.int32))


def _equal(outs, jouts, names):
    assert len(outs) == len(jouts) == len(names)
    for name, a, b in zip(names, outs, jouts):
        if name is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("start", ["reset", "mid"])
def test_b1_plain_matches_pallas_on_conveyor(conveyor, start):
    N, T = 128, 96  # the reference's lane block on conveyor; T past the 50-step limit
    cenv, jc = conveyor
    eng, jeng = rk.RolloutEngine(cenv, N), PallasRolloutEngine(jc, N)
    assert rk.placement(*eng.tables.shape) == "global"
    rng = np.random.default_rng(11 if start == "reset" else 12)
    state = _lanes(rng, cenv, N, start, eng.reset_idx)
    actions = rng.integers(0, 4, (T, N)).astype(np.int32)
    rk.counts.reset()
    rk.global_counts.reset()
    outs = rk.rollout(eng.tables, convert.engine_state_from_numpy(state, "cpu"),
                      torch.from_numpy(actions))
    assert rk.counts.plain_calls == 1 and rk.global_counts.launches == rk.counts.launches == 0
    jouts = jeng.run_actions(tuple(jnp.asarray(x).reshape(1, N) for x in state),
                             jnp.asarray(actions))
    _equal(outs, jouts, ["idx", "t", "ep_return", "ep_hidden", "ep_len", "reward_acc",
                         "episode_acc", "finished_return_acc"])
    assert float(outs[6].sum()) > N


def test_b2_plain_matches_pallas_on_conveyor(conveyor):
    N, T = 64, 32
    cenv, jc = conveyor
    hyper = dict(lr=0.2, epsilon=0.7, epsilon_anneal_steps=10_000)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, **hyper), VecEnv(cenv, N))
    jtr = PallasTabularQTrainer(JaxTabularQAgent(jc, **hyper), MXUVecEnv(jc, N))
    assert tk.placement(tr.S, tr.A, N) == "global"
    rng = np.random.default_rng(3)
    q = rng.normal(0.0, 1.0, (tr.S, tr.A)).astype(np.float32)
    state = _lanes(rng, cenv, N, "mid", tr.vec.reset_idx)
    rand_a = rng.integers(0, tr.A, (T, N)).astype(np.int32)
    u = rng.random((T, N), dtype=np.float32)
    step0 = 3_000
    astate = convert.tabular_state_from_numpy(q, step0, "cpu")
    outs = tk.tabq(tr.tables, tr.hyper, astate.q, convert.engine_state_from_numpy(state, "cpu"),
                   astate.step.reshape(1), torch.from_numpy(rand_a), torch.from_numpy(u))
    jouts = tabq_run(jtr._static, jtr._w2, jtr._qT(jnp.asarray(q)),
                     tuple(jnp.asarray(x).reshape(1, N) for x in state),
                     jnp.full((1, 1), step0, jnp.int32), jnp.asarray(rand_a), jnp.asarray(u))
    jq = np.asarray(jouts[0])[: tr.A, : tr.S].T
    np.testing.assert_allclose(outs[0].numpy(), jq, rtol=0, atol=1e-4)
    assert int(outs[6][0]) == int(np.asarray(jouts[6])[0, 0]) == step0 + T * N
    _equal(outs[1:6] + outs[7:], list(jouts[1:6]) + list(jouts[7:]),
           ["idx", "t", "ep_return", "ep_hidden", "ep_len", "episodes", "return_acc",
            "hidden_acc", "length_acc"])
    assert float(outs[7].sum()) > 0 and float((outs[0] - torch.from_numpy(q)).abs().max()) > 0


@pytest.mark.parametrize("mode", ["anneal", "warmup"])
def test_b3_plain_matches_pallas_on_conveyor(conveyor, mode):
    N, T = 128, 32
    cenv, jc = conveyor
    vec = VecEnv(cenv, N)
    jagent = JaxDQNAgent(jc, table=True, epsilon=0.6, epsilon_anneal_steps=5_000,
                         replay_capacity=4096)
    jtr = PallasDQNTrainer(jagent, MXUVecEnv(jc, N))
    assert dk.placement(vec.S, vec.A) == "global"
    rng = np.random.default_rng(21 if mode == "anneal" else 22)
    greedy = rng.integers(0, vec.A, vec.S).astype(np.int32)
    state = _lanes(rng, cenv, N, "mid", vec.reset_idx)
    rand_a = rng.integers(0, vec.A, (T, N)).astype(np.int32)
    u = rng.random((T, N), dtype=np.float32)
    step0 = 3_000
    row = jnp.zeros((1, jtr.S_pad), jtr._dtype).at[0, :vec.S].set(
        jnp.asarray(greedy).astype(jtr._dtype))
    static = jtr._static_warm if mode == "warmup" else jtr._static
    jouts = dqn_collect_run(static, jnp.concatenate([jtr._w_static, row], 0),
                            tuple(jnp.asarray(x).reshape(1, N) for x in state),
                            jnp.full((1, 1), step0, jnp.int32), jnp.asarray(rand_a),
                            jnp.asarray(u))
    hyper = dk.CollectHyper(0.6, 0.05, 5_000.0, False)
    if mode == "warmup":
        hyper = hyper.warmup()
    outs = dk.dqn_collect(Tables.from_env(cenv, vec.reset_idx), hyper, torch.from_numpy(greedy),
                          convert.engine_state_from_numpy(state, "cpu"),
                          torch.tensor([step0]), torch.from_numpy(rand_a), torch.from_numpy(u))
    assert int(outs[5][0]) == int(np.asarray(jouts[5])[0, 0]) == step0 + T * N
    _equal(outs, jouts, ["idx", "t", "ep_return", "ep_hidden", "ep_len", None, "episodes",
                         "return_acc", "hidden_acc", "length_acc", "pre_idx", "pre_t",
                         "action", "reward", "next_idx", "done"])


def test_b5_plain_matches_pallas_on_conveyor(conveyor):
    N, T = 128, 32
    cenv, jc = conveyor
    vec = VecEnv(cenv, N)
    jagent = JaxPPOAgent(jc, net="table")
    jtr = PallasPPOTrainer(jagent, MXUVecEnv(jc, N))
    assert pck.placement(vec.S, vec.A) == "global"
    payload = jtr._collect_payload(jagent.init(jax.random.PRNGKey(1)).params)
    rng = np.random.default_rng(31)
    state = _lanes(rng, cenv, N, "mid", vec.reset_idx)
    u = rng.random((T, N), dtype=np.float32)
    jouts = ppo_collect_run(jtr._cstatic, payload,
                            tuple(jnp.asarray(x).reshape(1, N) for x in state), jnp.asarray(u))
    outs = pck.ppo_collect(Tables.from_env(cenv, vec.reset_idx),
                           _payload_rows(jtr, payload, vec.S, vec.A),
                           convert.engine_state_from_numpy(state, "cpu"), torch.from_numpy(u))
    _equal(outs, jouts, ["idx", "t", "ep_return", "ep_hidden", "ep_len", "episodes",
                         "return_acc", "hidden_acc", "length_acc", "pre_idx", "pre_t",
                         "action", "logp", "value", "reward", "hidden", "done", "next_idx"])
    assert len(np.unique(outs[11].numpy())) == vec.A


# -- placements and the device-memory layouts ---------------------------------

GLOBAL = ("conveyor", "conveyor-sushi", "sokoban2")


def _shape(alias):
    if alias == "sokoban2":  # 175,616 slots: its index space, without the compile
        return Sokoban(level=1).num_states, 4
    return VecEnv(make_env(alias, compiled=True, device="cpu"), 1).tables.shape


@pytest.mark.parametrize("alias", ["shift", "shift-test", "island", "sokoban", "toy",
                                   "corners", "way", "boat", *GLOBAL])
def test_placement_of_every_deterministic_alias(alias):
    """Shared memory for every alias that had it, device memory for the
    conveyors and sokoban2, in all four kernels (B2 at the CLI's N = 64 and
    at its largest, 4096)."""
    S, A = _shape(alias)
    want = "global" if alias in GLOBAL else "shared"
    assert rk.placement(S, A) == dk.placement(S, A) == pck.placement(S, A) == want
    assert tk.placement(S, A, 64) == tk.placement(S, A, 4096) == want
    if want == "shared":
        assert rk.smem_bytes(S, A) <= SMEM_CAP and dk.smem_bytes(S, A) <= SMEM_CAP
        assert pck.smem_bytes(S, A) <= SMEM_CAP and tk.tile_steps(S, A, 4096, 128) >= 1
    else:
        assert rk.smem_bytes(S, A) > SMEM_CAP and tk.tile_steps(S, A, 64, 128) == 0


def test_every_registry_alias_has_a_placement_or_a_stochastic_kernel():
    stochastic = {"absent", "interrupt", "whisky", "tomato", "tomato-crmdp", "friend", "foe",
                  "neutral"}
    deterministic = set(ENV_REGISTRY) - stochastic
    assert len(ENV_REGISTRY) == 19 and len(deterministic) == 11
    for alias in deterministic:
        assert rk.placement(*_shape(alias)) in ("shared", "global")


def test_device_memory_layouts():
    """Without the tables only the tiles take shared memory; B2's tiles
    then go as deep as what is left allows (32 at N = 64 and 128, 3 at
    4096), and its work area sits 16-byte aligned after the lanes."""
    S, A = 7056, 4
    assert rk.smem_bytes(S, A, False) == rk.TILE_BYTES
    assert dk.smem_bytes(S, A, False) == dk.TILE_BYTES
    assert pck.smem_bytes(S, A, False) == pck.TILE_BYTES
    assert tk.base_bytes(S, A, False) == tk.EPS_BYTES
    assert [tk.tile_steps(S, A, n, 128, False) for n in (64, 128, 4096)] == [32, 32, 3]
    assert tk.smem_bytes(S, A, 4096, 128, False) == tk.EPS_BYTES + 16 * 4096 * 3
    for n in (1, 33, 64, 4096):
        off = tk.work_offset(S, A, n)
        assert off % 4 == 0 and off >= tk.HEAD_WORDS + S * A + 9 * n
        buf, outs = tk.carve_outputs(S, A, n, "cpu", work=True)
        assert buf.numel() == off + 3 * S * A
        _, plain = tk.carve_outputs(S, A, n, "cpu")
        assert [o.shape for o in outs] == [o.shape for o in plain]
        assert [o.storage_offset() for o in outs] == [o.storage_offset() for o in plain]
    with pytest.raises(ValueError, match="2\\^31"):
        rk.placement(40_000_000, 4)


def test_device_packed_tables_are_built_once(conveyor):
    cenv, _ = conveyor
    tables = Tables.from_env(cenv, VecEnv(cenv, 1).reset_idx)
    packed = rk.device_packed(tables)
    assert packed is rk.device_packed(tables) and packed.shape == (7056 * 4, 4)
    torch.testing.assert_close(packed, rk.packed_entries(tables), rtol=0, atol=0)
    tpacked = tk.device_packed(tables)
    assert tpacked is tk.device_packed(tables)
    torch.testing.assert_close(tpacked, tk.packed_entries(tables), rtol=0, atol=0)
    # B1's successor is a byte offset of a row, B2's a state index.
    torch.testing.assert_close(packed[:, 0], tpacked[:, 0] * 16 * 4, rtol=0, atol=0)
