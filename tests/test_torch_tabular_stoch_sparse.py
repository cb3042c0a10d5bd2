"""B8's sparse update, modelled on the CPU against the plain version.

The card kernel (csrc/tabular_stoch_kernel.cu) applies the duplicate-averaged
TD update only to the cells a step touched, each by the first lane that
added to the cell's count, where the plain version ``tabq_stoch_reference``
adds ``lr · Σtd / max(cnt, 1)`` to every cell. The kernel runs only on a
card, so this test holds a sparse model of its update (the touched cells,
their exact fixed-point sums and counts, one owner each) against the plain
version's dense update, bitwise, on hot-cell traffic (every lane on one
state after a reset, Q from zero) and on tomato's drying. It also checks the
argument that makes the two equal: no Q entry is ever -0.0.
"""
import pytest
import torch

from safe_grid_agents_torch.agents.tabular import TabularQAgent
from safe_grid_agents_torch.envs import make_env
from safe_grid_agents_torch.envs.vec import VecEnv
from safe_grid_agents_torch.ops import tabular_stoch_kernel as tsk
from safe_grid_agents_torch.training import FusedTabularQTrainer


def sparse_model(tables, hyper, q, state, step0, rand_a, u, bits, stumble, rand2):
    """The kernel's update order in plain PyTorch: per step, the owners of
    the touched cells (the first lane of each cell) apply the averaged TD of
    the cell; no other cell is written."""
    S, A = tables.shape
    T, N = rand_a.shape
    lr, gamma, eps0, eps_delta, anneal = (torch.tensor(v, dtype=torch.float32)
                                          for v in hyper.f32())
    q = q.clone()
    idx, t, epr, eph, epl = (x[0].clone() for x in state)
    lanes = torch.arange(N)
    for s in range(T):
        frac = ((step0 + s * N).to(torch.float32) / anneal).clamp(0.0, 1.0)
        greedy = q[idx.long()].argmax(-1).to(torch.int32)
        act = torch.where(u[s] < eps0 + frac * eps_delta, rand_a[s], greedy)
        kc = idx.long() * A + act.long()
        (idx, t, epr, eph, epl), (nxt, r, _, done, *_rest) = tables.step(
            idx, t, epr, eph, epl, act, bits[s], stumble[s], rand2[s])
        boot = q[nxt.long()].amax(-1)
        td = r + gamma * torch.where(done, torch.zeros_like(boot), boot) - q.view(-1)[kc]
        td_fx = torch.round(td * tsk.TD_SCALE).to(torch.int64)
        # The first adder of each cell owns it; its sum and count are exact.
        first = torch.full((S * A,), N, dtype=torch.int64).scatter_reduce_(
            0, kc, lanes, reduce="amin")
        owners = kc[first[kc] == lanes]
        assert len(owners) == len(torch.unique(kc))  # one owner per touched cell
        total = torch.zeros(S * A, dtype=torch.int64).index_add_(0, kc, td_fx)[owners]
        cnt = torch.bincount(kc, minlength=S * A)[owners].to(torch.float32)
        avg = (total.to(torch.float64) / tsk.TD_SCALE).to(torch.float32)
        q.view(-1)[owners] = q.view(-1)[owners] + lr * avg / cnt.clamp_min(1.0)
        assert not bool(((q == 0) & torch.signbit(q)).any())  # no -0.0 ever
    return q, (idx, t, epr, eph, epl)


def _case(alias, start, N, T, seed):
    cenv = make_env(alias, compiled=True, device="cpu")
    tr = FusedTabularQTrainer(TabularQAgent(cenv, lr=0.2, epsilon_anneal_steps=40_000),
                              VecEnv(cenv, N))
    g = torch.Generator().manual_seed(seed)
    state = tr.init(g)[1]
    if start == "hot":  # every lane on one state, at the start of an episode
        state = (torch.full((1, N), tr.tables.r0, dtype=torch.int32),) + tuple(
            torch.zeros_like(x) for x in state[1:])
    else:  # lanes spread over the reachable states, mid-episode
        reach = cenv.reachable
        state = (reach[torch.randint(0, len(reach), (1, N), generator=g)].to(torch.int32),
                 torch.randint(0, cenv.max_steps, (1, N), dtype=torch.int32, generator=g),
                 ) + tuple(x.clone() for x in state[2:])
    rand_a = torch.randint(0, tr.A, (T, N), dtype=torch.int32, generator=g)
    u = torch.rand((T, N), generator=g)
    streams = (rand_a, u) + tr.vec.draw_mechanics(g, T)
    # ε from 1 at step 0 to 0.05 at 40,000: mostly greedy late in the anneal.
    step0 = torch.tensor([30_000], dtype=torch.int64)
    return tr, torch.zeros(tr.S, tr.A), state, step0, streams


@pytest.mark.parametrize("alias, start", [
    ("absent", "hot"), ("tomato", "hot"), ("whisky", "hot"), ("tomato", "spread"),
])
def test_sparse_update_equals_the_dense_plain_version(alias, start):
    """N = 256 lanes; the hot cases put them all on the reset state, where
    most lanes pick the greedy action and share one (s, a) cell; the
    tomato cases step through its drying (the env steps the dried index,
    the agent learns at the observed one)."""
    tr, q0, state, step0, streams = _case(alias, start, 256, 48, seed=3)
    ref = tsk.tabq_stoch_reference(tr.tables, tr.hyper, q0, state, step0, *streams)
    q, lanes = sparse_model(tr.tables, tr.hyper, q0, state, step0, *streams)
    assert torch.equal(q, ref[0])
    for got, want in zip(lanes, ref[1:6]):
        assert torch.equal(got, want[0])
    assert bool((ref[0] != 0).any())  # the run learned something


def test_hot_cell_traffic_shares_cells():
    """The hot case really is hot: on the first step most of the 256 lanes
    add to one cell."""
    tr, q0, state, step0, (rand_a, u, *_rest) = _case("tomato", "hot", 256, 1, seed=3)
    eps = tr.hyper.f32()[2] + min(1.0, 30_000 / tr.hyper.f32()[4]) * tr.hyper.f32()[3]
    act = torch.where(u[0] < eps, rand_a[0], torch.zeros_like(rand_a[0]))
    kc = state[0][0].long() * tr.A + act.long()
    assert int(torch.bincount(kc).max()) > 200
