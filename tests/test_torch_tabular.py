"""Fused tabular-Q kernel B2, the tabular agent and the fused trainer.

The port's plain B2 is held against the JAX Pallas kernel (interpret mode on
the CPU, as its own tests run it) and against a numpy host replay, on the
same presampled draws. Tolerances: Q to atol 1e-4 — the TD sums are taken in
another order (the JAX kernel's lane-contraction matmul, the port's
index_add_), the reference's own tolerance (tests/test_tabular_kernel.py);
every integer-valued output must be equal.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the JAX package needs the whole stack
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from safe_grid_agents_tpu.agents.tabular import TabularQAgent as JaxTabularQAgent  # noqa: E402
from safe_grid_agents_tpu.envs import make_env as jax_make_env  # noqa: E402
from safe_grid_agents_tpu.envs.compiled import compile_env as jax_compile  # noqa: E402
from safe_grid_agents_tpu.envs.mxu import MXUVecEnv  # noqa: E402
from safe_grid_agents_tpu.ops.tabular_kernel import tabq_run  # noqa: E402
from safe_grid_agents_tpu.training.tabular_pallas import PallasTabularQTrainer  # noqa: E402
from safe_grid_agents_torch.agents.tabular import TabularQAgent  # noqa: E402
from safe_grid_agents_torch.convert import (  # noqa: E402
    engine_state_from_numpy, tabular_state_from_numpy,
)
from safe_grid_agents_torch.envs import make_env  # noqa: E402
from safe_grid_agents_torch.envs.vec import VecEnv  # noqa: E402
from safe_grid_agents_torch.ops import tabular_kernel as tk  # noqa: E402
from safe_grid_agents_torch.ops.rollout_kernel import Tables  # noqa: E402
from safe_grid_agents_torch.training import FusedTabularQTrainer, stats_to_host  # noqa: E402

torch.set_num_threads(1)
HYPER = dict(lr=0.1, epsilon=0.7, epsilon_anneal_steps=10_000)


def _draws(rng, T, N, S, A, reachable):
    return dict(
        rand_a=rng.integers(0, A, (T, N)).astype(np.int32),
        u=rng.random((T, N), dtype=np.float32),
        q=rng.normal(0.0, 1.0, (S, A)).astype(np.float32),
        state=(rng.choice(reachable, N).astype(np.int32),
               rng.integers(0, 100, N).astype(np.int32),
               rng.integers(-20, 5, N).astype(np.float32),
               rng.integers(-20, 5, N).astype(np.float32),
               rng.integers(0, 40, N).astype(np.int32)),
    )


def test_tabq_plain_matches_pallas_kernel():
    N, T = 64, 128
    cenv = make_env("shift", compiled=True, device="cpu")
    vec = VecEnv(cenv, N)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, **HYPER), vec)
    jc = jax_compile(jax_make_env("shift"))
    jtr = PallasTabularQTrainer(JaxTabularQAgent(jc, **HYPER), MXUVecEnv(jc, N))
    d = _draws(np.random.default_rng(0), T, N, vec.S, vec.A, cenv.reachable.numpy())
    step0 = 3_000

    tk.counts.reset()
    astate = tabular_state_from_numpy(d["q"], step0, "cpu")
    outs = tk.tabq(tr.tables, tr.hyper, astate.q,
                   engine_state_from_numpy(d["state"], "cpu"),
                   astate.step.reshape(1), torch.from_numpy(d["rand_a"]),
                   torch.from_numpy(d["u"]))
    assert tk.counts.plain_calls == 1 and tk.counts.launches == 0
    jouts = tabq_run(
        jtr._static, jtr._w2, jtr._qT(jnp.asarray(d["q"])),
        tuple(jnp.asarray(x).reshape(1, N) for x in d["state"]),
        jnp.full((1, 1), step0, jnp.int32),
        jnp.asarray(d["rand_a"]), jnp.asarray(d["u"]),
    )
    jq = np.asarray(jouts[0])[: vec.A, : vec.S].T
    np.testing.assert_allclose(outs[0].numpy(), jq, rtol=0, atol=1e-4)
    assert int(outs[6][0]) == int(np.asarray(jouts[6])[0, 0]) == step0 + T * N
    names = ["idx", "t", "ep_return", "ep_hidden", "ep_len", None,
             "episodes", "return_acc", "hidden_acc", "length_acc"]
    for i, name in enumerate(names, start=1):
        if name is not None:
            np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]),
                                          err_msg=name)
    assert float(outs[7].sum()) > 0  # episodes ended inside the chunk


def test_tabq_plain_matches_pallas_kernel_step_by_step_from_a_hot_reset():
    """N = 4096 lanes all on shift's reset state with zero Q, late in the ε
    anneal: most lanes share one (s, a) cell, whose fixed-point TD sum over
    ~3,000 lanes is held against the JAX kernel's lane-contraction matmul.
    Over a whole chunk from such a start the two part (float sums in lane
    order part sooner): ties of Q, such as two actions that bump into one
    wall, break on last-bit differences of the sums (the test below). So
    each of 48 steps starts both from the JAX kernel's state: Q to atol
    1e-4, every integer-valued output equal."""
    N, steps, step0 = 4096, 48, 15_000
    hyper = dict(lr=0.2, epsilon_anneal_steps=20_000)
    cenv = make_env("shift", compiled=True, device="cpu")
    vec = VecEnv(cenv, N)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, **hyper), vec)
    jc = jax_compile(jax_make_env("shift"))
    jtr = PallasTabularQTrainer(JaxTabularQAgent(jc, **hyper), MXUVecEnv(jc, N))
    rng = np.random.default_rng(11)
    q = np.zeros((vec.S, vec.A), np.float32)
    state = (np.full(N, vec.reset_idx, np.int32), np.zeros(N, np.int32),
             np.zeros(N, np.float32), np.zeros(N, np.float32), np.zeros(N, np.int32))
    episodes = 0
    for s in range(steps):
        rand_a = rng.integers(0, vec.A, (1, N)).astype(np.int32)
        u = rng.random((1, N), dtype=np.float32)
        astate = tabular_state_from_numpy(q, step0 + s * N, "cpu")
        outs = tk.tabq(tr.tables, tr.hyper, astate.q, engine_state_from_numpy(state, "cpu"),
                       astate.step.reshape(1), torch.from_numpy(rand_a), torch.from_numpy(u))
        jouts = tabq_run(jtr._static, jtr._w2, jtr._qT(jnp.asarray(q)),
                         tuple(jnp.asarray(x).reshape(1, N) for x in state),
                         jnp.full((1, 1), step0 + s * N, jnp.int32),
                         jnp.asarray(rand_a), jnp.asarray(u))
        q = np.ascontiguousarray(np.asarray(jouts[0])[: vec.A, : vec.S].T)
        np.testing.assert_allclose(outs[0].numpy(), q, rtol=0, atol=1e-4, err_msg=f"step {s}")
        for i in (1, 2, 3, 4, 5, 7, 8, 9, 10):
            np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]),
                                          err_msg=f"step {s} output {i}")
        state = tuple(np.asarray(jouts[i])[0] for i in range(1, 6))
        episodes += int(outs[7].sum())
    assert episodes > 0


HOT = dict(N=4096, steps=48, step0=15_000, hyper=dict(lr=0.2, epsilon_anneal_steps=20_000))


@pytest.fixture(scope="module")
def hot_chunk():
    """The hot-reset start of the test above and the JAX kernel's whole
    chunk from it: its Q and lane state after every step, from one-step
    calls chained on its own state, held equal to one call over the whole
    chunk."""
    N, steps, step0 = HOT["N"], HOT["steps"], HOT["step0"]
    cenv = make_env("shift", compiled=True, device="cpu")
    vec = VecEnv(cenv, N)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, **HOT["hyper"]), vec)
    jc = jax_compile(jax_make_env("shift"))
    jtr = PallasTabularQTrainer(JaxTabularQAgent(jc, **HOT["hyper"]), MXUVecEnv(jc, N))
    rng = np.random.default_rng(11)
    rand_a = rng.integers(0, vec.A, (steps, N)).astype(np.int32)
    u = rng.random((steps, N), dtype=np.float32)
    q0 = np.zeros((vec.S, vec.A), np.float32)
    state0 = (np.full(N, vec.reset_idx, np.int32), np.zeros(N, np.int32),
              np.zeros(N, np.float32), np.zeros(N, np.float32), np.zeros(N, np.int32))

    def run(q, state, s0, s1):
        jouts = tabq_run(jtr._static, jtr._w2, jtr._qT(jnp.asarray(q)),
                         tuple(jnp.asarray(x).reshape(1, N) for x in state),
                         jnp.full((1, 1), step0 + s0 * N, jnp.int32),
                         jnp.asarray(rand_a[s0:s1]), jnp.asarray(u[s0:s1]))
        return (np.ascontiguousarray(np.asarray(jouts[0])[: vec.A, : vec.S].T),
                tuple(np.asarray(jouts[i])[0] for i in range(1, 6)))

    traj = [(q0, state0)]
    for s in range(steps):
        traj.append(run(*traj[-1], s, s + 1))
    whole_q, whole_state = run(q0, state0, 0, steps)
    np.testing.assert_array_equal(whole_q, traj[-1][0])
    for a, b in zip(whole_state, traj[-1][1]):
        np.testing.assert_array_equal(a, b)
    return tr, rand_a, u, traj


def _float_sum_step(tr, q, state, step, rand_a, u):
    """One step of the plain version with each cell's TD errors summed as
    float32 in lane order (``index_add_``) instead of in fixed point."""
    outs = tk.tabq_reference(tr.tables, tr.hyper, q, state, step, rand_a, u)
    S, A = tr.tables.shape
    lr, gamma, eps0, eps_delta, anneal = (torch.tensor(v) for v in tr.hyper.f32())
    idx, t = state[0][0].long(), state[1][0]
    eps_t = eps0 + (step.to(torch.float32) / anneal).clamp(0.0, 1.0) * eps_delta
    act = torch.where(u[0] < eps_t, rand_a[0], q[idx].argmax(-1).to(torch.int32))
    k = idx * A + act.long()
    nxt = tr.tables.next.view(-1)[k].long()
    done = tr.tables.done.view(-1).bool()[k] | (t + 1 >= tr.tables.max_steps)
    boot = torch.where(done, torch.zeros(len(k)), q[nxt].amax(-1))
    td = tr.tables.reward.view(-1)[k] + gamma * boot - q.view(-1)[k]
    td_sum = torch.zeros(S * A).index_add_(0, k, td)
    cnt = torch.zeros(S * A).index_add_(0, k, torch.ones(len(k)))
    return (q + (lr * td_sum / cnt.clamp_min(1.0)).view(S, A),) + tuple(outs[1:])


@pytest.mark.parametrize("sums", ["fixed point", "float in lane order"])
def test_tabq_plain_parts_from_pallas_kernel_only_on_ties_over_a_hot_chunk(hot_chunk, sums):
    """The whole chunk of the test above, the plain version and the JAX
    kernel each on its own state. Every step agrees (Q to atol 1e-4, lane
    state equal) until the first step whose next states differ; on this
    draw that step is 10 with the plain version's fixed-point sums and 2
    with float sums in lane order. There, every lane that parts took
    another greedy action, on a row whose two largest Q values tie to
    within 1e-5 in both: the sums' last bits broke a tie between two
    actions of equal value. With fixed-point sums the plain version's tie
    is exact; the matmul's rounding broke it."""
    tr, rand_a, u, traj = hot_chunk
    N, step0 = HOT["N"], HOT["step0"]
    step = tk.tabq if sums == "fixed point" else functools.partial(_float_sum_step, tr)
    q, state = traj[0]
    for s in range(HOT["steps"]):
        args = (torch.from_numpy(q), engine_state_from_numpy(state, "cpu"),
                torch.tensor([step0 + s * N]), torch.from_numpy(rand_a[s:s + 1]),
                torch.from_numpy(u[s:s + 1]))
        outs = (step(tr.tables, tr.hyper, *args) if sums == "fixed point" else step(*args))
        jq, jstate = traj[s + 1]
        idx = outs[1][0].numpy()
        if not np.array_equal(idx, jstate[0]):
            break
        np.testing.assert_allclose(outs[0].numpy(), jq, rtol=0, atol=1e-4, err_msg=f"step {s}")
        for i in range(1, 6):
            np.testing.assert_array_equal(outs[i][0].numpy(), jstate[i - 1], err_msg=f"step {s}")
        q, state = outs[0].numpy(), tuple(outs[i][0].numpy() for i in range(1, 6))
    else:
        return  # the whole chunk agrees
    print(f"{sums}: the plain version parts from the JAX kernel at step {s}, "
          f"{int((idx != jstate[0]).sum())} lanes")
    assert s == (10 if sums == "fixed point" else 2)
    jq_in = traj[s][0]
    rows = state[0]
    parted = idx != jstate[0]
    assert np.all(q[rows[parted]].argmax(-1) != jq_in[rows[parted]].argmax(-1))
    for qq in (q, jq_in):
        top2 = np.sort(qq[rows[parted]], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] <= 1e-5)
    np.testing.assert_allclose(q[rows[parted]], jq_in[rows[parted]], rtol=0, atol=1e-5)
    if sums == "fixed point":
        top2 = np.sort(q[rows[parted]], axis=-1)[:, -2:]
        assert np.all(top2[:, 1] == top2[:, 0])


def test_tabq_plain_matches_host_replay():
    """The numpy host replay of tests/test_tabular_kernel.py, run on shift
    from zero Q and a fresh reset."""
    N, T = 32, 64
    cenv = make_env("shift", compiled=True, device="cpu")
    agent = TabularQAgent(cenv, **HYPER)
    tr = FusedTabularQTrainer(agent, VecEnv(cenv, N))
    rng = np.random.default_rng(5)
    rand_a = rng.integers(0, 4, (T, N)).astype(np.int32)
    u = rng.random((T, N), dtype=np.float32)
    astate, vstate = tr.init()
    outs = tk.tabq(tr.tables, tr.hyper, astate.q, vstate, astate.step.reshape(1),
                   torch.from_numpy(rand_a), torch.from_numpy(u))

    q = np.zeros((cenv.num_states, cenv.n_actions), np.float32)
    nxt_t, rew_t = cenv.next_table.numpy(), cenv.reward_table.numpy()
    done_t = cenv.done_table.numpy()
    reset_idx = tr.vec.reset_idx
    idx = np.full((N,), reset_idx, np.int64)
    t = np.zeros((N,), np.int64)
    epr = np.zeros((N,), np.float64)
    step = 0
    episodes = ret_sum = 0.0
    for s in range(T):
        frac = min(max(step / agent.epsilon_anneal_steps, 0.0), 1.0)
        eps = agent.epsilon + frac * (agent.epsilon_final - agent.epsilon)
        a = np.where(u[s] < eps, rand_a[s], q[idx].argmax(-1))
        nxt, r = nxt_t[idx, a], rew_t[idx, a]
        done = done_t[idx, a] | (t + 1 >= cenv.max_steps)
        td = r + agent.discount * np.where(done, 0.0, q[nxt].max(-1)) - q[idx, a]
        td_sum = np.zeros_like(q)
        cnt = np.zeros_like(q)
        np.add.at(td_sum, (idx, a), td)
        np.add.at(cnt, (idx, a), 1.0)
        q = q + agent.lr * td_sum / np.maximum(cnt, 1.0)
        epr = epr + r
        episodes += done.sum()
        ret_sum += (epr * done).sum()
        idx = np.where(done, reset_idx, nxt)
        t = np.where(done, 0, t + 1)
        epr = np.where(done, 0.0, epr)
        step += N

    np.testing.assert_allclose(outs[0].numpy(), q, rtol=0, atol=1e-4)
    assert float(outs[7].sum()) == episodes > 0
    assert abs(float(outs[8].sum()) - ret_sum) < 1e-3
    np.testing.assert_array_equal(outs[1].numpy()[0], idx)


def test_agent_greedy_ties_and_epsilon_match_jax():
    cenv = make_env("shift", compiled=True, device="cpu")
    jc = jax_compile(jax_make_env("shift"))
    agent = TabularQAgent(cenv, epsilon=0.9, epsilon_final=0.05, epsilon_anneal_steps=7_000)
    jagent = JaxTabularQAgent(jc, epsilon=0.9, epsilon_final=0.05, epsilon_anneal_steps=7_000)
    q = np.zeros((cenv.num_states, 4), np.float32)
    q[1] = [1, 3, 3, 2]
    q[2] = [5, 5, 1, 5]
    q[3] = [-1, -2, -1, -1]
    q[4] = [0, 0, 0, 7]
    idx = np.array([0, 1, 2, 3, 4, 1], np.int32)
    astate = tabular_state_from_numpy(q, 0, "cpu")
    jstate = jagent.init(jax.random.PRNGKey(0)).replace(q=jnp.asarray(q))
    np.testing.assert_array_equal(
        agent.act_idx(astate, torch.from_numpy(idx)).numpy(),
        np.asarray(jagent.act_idx(jstate, jnp.asarray(idx), None)),
    )
    for step in (0, 1, 64, 3_333, 6_999, 7_000, 123_456, 2**31 - 1):
        got = agent.current_epsilon(torch.tensor(step)).numpy()
        want = np.asarray(jagent.current_epsilon(jnp.int32(step)))
        assert got.dtype == want.dtype and got == want, step


def test_agent_learn_matches_jax():
    cenv = make_env("shift", compiled=True, device="cpu")
    jc = jax_compile(jax_make_env("shift"))
    agent, jagent = TabularQAgent(cenv, lr=0.3), JaxTabularQAgent(jc, lr=0.3)
    rng = np.random.default_rng(4)
    reach = cenv.reachable.numpy()
    n = 200
    q = rng.normal(0.0, 1.0, (cenv.num_states, 4)).astype(np.float32)
    batch = (rng.choice(reach, n).astype(np.int32),
             rng.integers(0, 4, n).astype(np.int32),
             rng.integers(-51, 50, n).astype(np.float32),
             rng.choice(reach, n).astype(np.int32),
             rng.random(n) < 0.2)
    new = agent.learn(tabular_state_from_numpy(q, 10, "cpu"),
                      *(torch.from_numpy(x) for x in batch))
    jnew = jagent.learn(jagent.init(None).replace(q=jnp.asarray(q), step=jnp.int32(10)),
                        *(jnp.asarray(x) for x in batch))
    np.testing.assert_allclose(new.q.numpy(), np.asarray(jnew.q), rtol=0, atol=1e-6)
    assert int(new.step) == int(jnew.step) == 10 + n


def test_fused_trainer_learns_shift():
    cenv = make_env("shift", compiled=True, device="cpu")
    agent = TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000)
    tr = FusedTabularQTrainer(agent, VecEnv(cenv, 64))
    astate, vstate = tr.init()
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        astate, vstate, stats = tr.train_chunk(astate, vstate, g, 128)
    assert int(astate.step) == 8 * 128 * 64
    _, es = tr.eval_chunk(astate, tr.vec.reset(), 30)
    s = stats_to_host(es)
    assert s["mean_return"] > 38.0, s  # shift optimum is 40


def test_fused_trainer_pins_lane_count():
    cenv = make_env("shift", compiled=True, device="cpu")
    with pytest.raises(ValueError, match="4096"):
        FusedTabularQTrainer(TabularQAgent(cenv), VecEnv(cenv, 4097))
    tables = Tables.from_env(cenv, 10)
    with pytest.raises(ValueError, match="lanes"):
        tk.tabq(tables, tk.TabQHyper(0.1, 0.99, 1.0, 0.01, 1.0),
                torch.zeros(cenv.num_states, 4), None, None,
                torch.zeros((1, 4097), dtype=torch.int32), None)
