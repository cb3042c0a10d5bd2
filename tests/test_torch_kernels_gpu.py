"""Card-only legs: each CUDA kernel against its plain PyTorch version.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is visible.
They import no JAX, so on the machine with the card they run with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: B1 and B3 are exact (bitwise). B2's Q sums TD errors with
shared-memory float atomics in a run-dependent order: one step from a random
Q is held to rtol/atol 1e-6, 256 steps from zero Q to atol 1e-4 (the
reference's own); integer-valued outputs must be equal. B4 sums its
gradients in another order than autograd's matmuls: params, target, μ and ν
to rtol 2e-4 / atol 1e-6, the loss to rtol 2e-5 (the reference's own,
tests/test_dqn_update_kernel.py).
"""
import pytest
import torch

from safe_grid_agents_torch.agents.dqn import DQNAgent
from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import dqn_kernel as dk
from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import rollout_kernel as rk
from safe_grid_agents_torch.ops import tabular_kernel as tk
from safe_grid_agents_torch.training import (
    FusedDQNTrainer, FusedTabularQTrainer, stats_to_host,
)
from safe_grid_agents_torch.types import map_fields

pytestmark = pytest.mark.gpu
N = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mid_episode(cenv, g, dev):
    """A seeded random lane state on reachable indices."""
    reach = cenv.reachable
    pick = torch.randint(0, len(reach), (1, N), generator=g, device=dev)
    return (
        reach[pick].to(torch.int32),
        torch.randint(0, cenv.max_steps, (1, N), dtype=torch.int32, generator=g, device=dev),
        torch.randint(-30, 5, (1, N), generator=g, device=dev).to(torch.float32),
        torch.randint(-30, 5, (1, N), generator=g, device=dev).to(torch.float32),
        torch.randint(0, 60, (1, N), dtype=torch.int32, generator=g, device=dev),
    )


@pytest.mark.parametrize("alias", ["shift", "shift-test"])
@pytest.mark.parametrize("start", ["reset", "mid-episode"])
def test_rollout_kernel_matches_plain(cuda, alias, start):
    eng = rk.RolloutEngine(make_env(alias, compiled=True, device=cuda), N)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = eng.reset() if start == "reset" else _mid_episode(eng.cenv, g, cuda)
    actions = torch.randint(0, eng.A, (1024, N), dtype=torch.int32, generator=g, device=cuda)
    launches = rk.counts.launches
    outs = eng.run_actions(state, actions)
    torch.cuda.synchronize()
    assert rk.counts.launches == launches + 1
    ref = rk.rollout_reference(eng.tables, state, actions)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["one-step-random-q", "256-steps-zero-q"])
def test_tabular_kernel_matches_plain(cuda, case):
    cenv = make_env("shift", compiled=True, device=cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, N))
    g = torch.Generator(device=cuda).manual_seed(1)
    if case == "one-step-random-q":
        T, tol = 1, dict(rtol=1e-6, atol=1e-6)
        q = torch.randn(tr.S, tr.A, generator=g, device=cuda)
        state = _mid_episode(cenv, g, cuda)
    else:
        T, tol = 256, dict(rtol=0.0, atol=1e-4)
        q = torch.zeros(tr.S, tr.A, device=cuda)
        state = tr.init()[1]
    step0 = torch.tensor([1_000], dtype=torch.int64, device=cuda)
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((T, N), generator=g, device=cuda)
    outs = tk.tabq(tr.tables, tr.hyper, q, state, step0, rand_a, u)
    torch.cuda.synchronize()
    ref = tk.tabq_reference(tr.tables, tr.hyper, q, state, step0, rand_a, u)
    torch.testing.assert_close(outs[0], ref[0], **tol)
    for a, b in zip(outs[1:], ref[1:]):
        assert torch.equal(a, b)


def test_fused_trainer_learns_shift_on_card(cuda):
    cenv = make_env("shift", compiled=True, device=cuda)
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=20_000),
                              VecEnv(cenv, 64))
    astate, vstate = tr.init()
    g = torch.Generator(device=cuda).manual_seed(1)
    launches, plain = tk.counts.launches, tk.counts.plain_calls
    for _ in range(8):
        astate, vstate, _ = tr.train_chunk(astate, vstate, g, 128)
    assert tk.counts.launches == launches + 8 and tk.counts.plain_calls == plain
    _, es = tr.eval_chunk(astate, tr.vec.reset(), 30)
    assert stats_to_host(es)["mean_return"] > 38.0


def _dqn_trainer(dev, n, **kw):
    cenv = make_env("sokoban", compiled=True, device=dev)
    agent = DQNAgent(cenv, **{**dict(lr=5e-4, epsilon=0.6, epsilon_anneal_steps=60_000,
                                     batch_size=128, replay_capacity=50_000,
                                     sync_every=100), **kw})
    return FusedDQNTrainer(agent, VecEnv(cenv, n), updates_per_chunk=32)


@pytest.mark.parametrize("start", ["reset", "mid-episode"])
@pytest.mark.parametrize("warm", [False, True])
def test_dqn_collect_kernel_matches_plain(cuda, start, warm):
    tr = _dqn_trainer(cuda, N)
    g = torch.Generator(device=cuda).manual_seed(2)
    astate, state = tr.init()
    if start == "mid-episode":
        state = _mid_episode(tr.vec.cenv, g, cuda)
    greedy = torch.randint(0, tr.A, (tr.S,), dtype=torch.int32, generator=g, device=cuda)
    rand_a = torch.randint(0, tr.A, (1024, N), dtype=torch.int32, generator=g, device=cuda)
    u = torch.rand((1024, N), generator=g, device=cuda)
    step0 = torch.tensor([40_000], dtype=torch.int64, device=cuda)
    hyper = tr.hyper.warmup() if warm else tr.hyper
    launches = dk.counts.launches
    outs = dk.dqn_collect(tr.tables, hyper, greedy, state, step0, rand_a, u)
    torch.cuda.synchronize()
    assert dk.counts.launches == launches + 1
    ref = dk.dqn_collect_reference(tr.tables, hyper, greedy, state, step0, rand_a, u)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("table,double_q", [(True, False), (False, False), (True, True)])
def test_dqn_update_kernel_matches_plain(cuda, table, double_q):
    tr = _dqn_trainer(cuda, 128, table=table, double_q=double_q, sync_every=3, n_step=3)
    g = torch.Generator(device=cuda).manual_seed(3)
    astate, vstate = tr.init()
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 64)
    idxs = torch.randint(0, astate.buffer.size, (8, 128), generator=g, device=cuda)
    batch = map_fields(lambda x: x[idxs], astate.buffer.storage)
    args = (astate.params, astate.target_params, astate.mu, astate.nu,
            astate.count.reshape(1), astate.updates.reshape(1))
    for _ in range(2):  # from a fresh state, then from one with counts 8 and 8
        launches = duk.counts.launches
        outs = duk.dqn_update(tr.agent, *args, batch)
        torch.cuda.synchronize()
        assert duk.counts.launches == launches + 1
        ref = duk.dqn_update_reference(tr.agent, *args, batch)
        for got, want in zip(outs[:4], ref[:4]):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=2e-4, atol=1e-6)
        assert torch.equal(outs[4], ref[4]) and torch.equal(outs[5], ref[5])
        torch.testing.assert_close(outs[6], ref[6], rtol=2e-5, atol=0.0)
        args = ref[:6]


def test_fused_dqn_trainer_learns_sokoban_on_card(cuda):
    tr = _dqn_trainer(cuda, 128, epsilon=1.0)
    astate, vstate = tr.init()
    g = torch.Generator(device=cuda).manual_seed(2)
    plain = (dk.counts.plain_calls, duk.counts.plain_calls)
    launches = (dk.counts.launches, duk.counts.launches)
    astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 32)
    best = -1e9
    for i in range(15):
        astate, vstate, _, loss = tr.train_chunk(astate, vstate, g, 32)
        if i >= 8:
            _, es = tr.eval_chunk(astate, tr.vec.reset(), 60)
            best = max(best, stats_to_host(es)["mean_return"])
    assert (dk.counts.plain_calls, duk.counts.plain_calls) == plain
    assert (dk.counts.launches - launches[0], duk.counts.launches - launches[1]) == (16, 15)
    assert best >= 40.0, best
