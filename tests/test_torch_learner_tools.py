"""The learner tools' CPU-side parts: the cases they build, the phase
stamp markers in the two sources that the trace tool turns on, the
CPU-stream context of the whisky check, and the parity helpers, on the CPU
(the kernels themselves run only on a card: tests/test_torch_kernels_gpu.py)."""
import re

import pytest
import torch

from safe_grid_agents_torch.ops import _build
from safe_grid_agents_torch.ops import dqn_update_kernel as duk
from safe_grid_agents_torch.ops import ppo_kernel as pk
from safe_grid_agents_torch.tools import learner_cases as lc
from safe_grid_agents_torch.tools import trace_learners as tl
from safe_grid_agents_torch.tools import whisky_streams as ws

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("name, U, B, hidden", [
    ("sokoban", 32, 128, (128, 128)), ("whisky", 32, 128, (128, 128)),
    ("ragged", 8, 100, (100, 60)), ("ragged_wide", 8, 600, (100, 60)),
])
def test_dqn_cases_have_the_main_path_shapes(name, U, B, hidden):
    agent, args = lc.dqn_case(name, CPU, torch.Generator().manual_seed(0))
    assert agent.hidden == hidden and args[-1].action.shape == (U, B)
    assert args[0]["w1"].shape == (agent.obs_flat.shape[1], hidden[0])


@pytest.mark.parametrize("name, U, B, S", [
    ("island", 16, 16384, 72), ("absent", 16, 8192, 98), ("ragged", 4, 16700, 72),
])
def test_ppo_cases_have_the_main_path_shapes(name, U, B, S):
    agent, args = lc.ppo_case(name, CPU, torch.Generator().manual_seed(0))
    assert agent.obs_flat.shape[0] == S
    assert all(t.shape == (U, B) for t in args[-1])
    reach = set(agent.env.reachable.tolist())
    assert set(args[-1][0].unique().tolist()) <= reach


@pytest.mark.parametrize("name, B, hidden, route", [
    ("hidden512", 128, (512, 512), "grid"), ("batch4096", 4096, (128, 128), "grid"),
    ("ragged_grid", 1000, (300, 300), "grid"), ("sync_grid", 128, (512, 512), "grid"),
])
def test_restored_dqn_cases_take_the_one_block_route(name, B, hidden, route):
    """The sokoban command's shapes no cluster holds (and the ragged and
    double-Q cases of the card legs) take B4's grid route."""
    agent, args = lc.dqn_case(name, CPU, torch.Generator().manual_seed(0), updates=2)
    assert agent.hidden == hidden and args[-1].action.shape == (2, B)
    D = agent.obs_flat.shape[1]
    assert duk.route(D, *hidden, agent.env.n_actions, B) == route


def test_restored_ppo_case_takes_the_wide_route():
    agent, args = lc.ppo_case("island256", CPU, torch.Generator().manual_seed(0), updates=2)
    S, D = agent.obs_flat.shape
    assert agent.hidden == (256, 256) and all(t.shape == (2, 16384) for t in args[-1])
    assert pk.route(S, D, 256, 256, agent.env.n_actions) == "wide"


@pytest.mark.parametrize("name, B, H, A", [
    ("ragged256", 16700, 256, 4), ("actions8", 4100, 128, 8), ("wide1813", 1000, 1813, 4),
])
def test_wide_route_cases_have_their_shapes(name, B, H, A):
    """B6's wide-route card legs: a ragged last tile, 8 actions (the fused
    trainer packs at most 7, the optimize takes any) and a width above 512;
    the actions lie in [0, A)."""
    agent, args = lc.ppo_case(name, CPU, torch.Generator().manual_seed(0), updates=1)
    S, D = agent.obs_flat.shape
    assert agent.hidden == (H, H) and agent.env.n_actions == A
    assert all(t.shape == (1, B) for t in args[-1])
    assert int(args[-1][1].max()) < A and args[0].numel() == sum(
        int(torch.tensor(v).prod()) for v in agent.shapes.values())
    assert pk.route(S, D, H, H, A) == "wide"


@pytest.mark.parametrize("name", sorted(lc.B8_CASES))
def test_b8_cases_have_their_shapes(name):
    alias, N, T = lc.B8_CASES[name]
    args = lc.tabq_stoch_case(name, CPU, torch.Generator().manual_seed(0))
    assert all(x.shape == (T, N) for x in args[5:])
    assert all(x.shape == (1, N) for x in args[3])
    assert not bool(args[2].any())  # Q from zero, as a trainer starts


def test_b8_hot_case_puts_every_lane_on_one_state():
    args = lc.tabq_stoch_case("tomato cli", CPU, torch.Generator().manual_seed(0), hot=True)
    assert len(args[3][0].unique()) == 1 and int(args[4][0]) == 35_000


# Friend at cap 127 takes minutes to compile on the CPU; it is built on the card.
@pytest.mark.parametrize("name", sorted(k for k in lc.B10_CASES if not k.startswith("friend")))
def test_b10_cases_have_their_shapes(name):
    alias, kw, N, T = lc.B10_CASES[name]
    args = lc.ppo_stoch_case(name, CPU, torch.Generator().manual_seed(0))
    assert all(x.shape == (T, N) for x in args[3:]) and T % 16 == 0


def test_plain_dqn_update_is_reproducible_and_meets_its_own_check():
    agent, args = lc.dqn_case("ragged", CPU, torch.Generator().manual_seed(1))
    first = duk.dqn_update(agent, *args)
    second = duk.dqn_update(agent, *args)
    assert lc.outputs_equal(first, second)
    assert lc.check_b4(first, second) == 0.0


def _stamps(name):
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert "#ifdef SGA_TRACE" in src
    return sorted(int(i) for i in re.findall(r"SGA_STAMP\((\d+)\);", src))


def test_trace_stamps_cover_every_phase_of_the_cluster_design():
    """Each phase of B4's update has its marker, once, within the stamp
    buffer's row; the tool's phase names match the markers."""
    stamps = _stamps("dqn_update_kernel")
    assert tuple(stamps) == tl.stamp_indices("dqn_update_kernel")
    assert len(stamps) == len(tl.B4_PHASES) + 1 and stamps[-1] < tl.B4_STAMPS[1]


def test_trace_stamps_cover_every_phase_of_the_persistent_design():
    """B6's grad and finish kernels carry one marker for each phase boundary
    the tool names, within the stamp buffer's row."""
    stamps = _stamps("ppo_kernel")
    assert tuple(stamps) == tl.stamp_indices("ppo_kernel")
    assert stamps[len(tl.B6_GRAD_PHASES) + 1] == tl.B6_FINISH_FIRST
    assert stamps[-1] < tl.B6_STAMPS[1]


@pytest.mark.parametrize("name, phases, shape", [
    ("dqn_update_grid", tl.B4_GRID_PHASES, tl.B4_GRID_STAMPS),
    ("ppo_wide_kernel", tl.B6_WIDE_PHASES, tl.B6_WIDE_STAMPS),
])
def test_trace_stamps_cover_every_phase_of_the_grid_routes(name, phases, shape):
    """B4's grid and B6's wide kernels carry one marker after each grid
    barrier the tool names a phase for, within the stamp buffer's row."""
    stamps = _stamps(name)
    assert tuple(stamps) == tl.stamp_indices(name)
    assert len(stamps) == len(phases) + 1 and stamps[-1] < shape[1]


def test_trace_stamps_cover_every_phase_of_the_stochastic_tabular_step():
    """B8 carries one marker for each phase boundary of a step that the
    tool names, within the stamp buffer's row."""
    stamps = _stamps("tabular_stoch_kernel")
    assert tuple(stamps) == tl.stamp_indices("tabular_stoch_kernel")
    assert len(stamps) == len(tl.B8_PHASES) + 1 and stamps[-1] < tl.B8_STAMPS[1]


def test_cpu_streams_makes_cpu_generators_and_restores_torch():
    rand, gen = torch.rand, torch.Generator
    with ws.cpu_streams():
        g = torch.Generator(device="cuda")
        assert g.device.type == "cpu"
        g.manual_seed(3)
        x = torch.rand(4, generator=g, device="cpu")
    assert torch.rand is rand and torch.Generator is gen
    assert torch.equal(x, torch.rand(4, generator=torch.Generator().manual_seed(3)))


def test_b4_conditioning_holds_the_plain_version_against_itself(capsys):
    """The conditioning tool on the CPU: the plain B4 with each update's rows
    permuted against the plain B4 (the kernels need a card); a short
    prefix of a small case stays within the check's tolerance, and the
    permutation keeps every update's rows."""
    from safe_grid_agents_torch.tools import b4_conditioning as b4c
    rows = b4c.condition("ragged", 0, (1, 2), CPU)
    assert set(rows) == {1, 2} and all(set(r) == {"permuted"} for r in rows.values())
    assert all(r["permuted"][0] == 0 and r["permuted"][1] < 1e-5 for r in rows.values())
    _, args = lc.dqn_case("ragged", CPU, torch.Generator().manual_seed(0))
    perm = b4c.permute_rows(args[6], 3)
    for a, b in zip((args[6].s_idx, args[6].reward), (perm.s_idx, perm.reward)):
        assert torch.equal(a.sort(1).values, b.sort(1).values)
    assert "ragged seed 0 U=2: permuted 0 beyond" in capsys.readouterr().out


def test_trace_stamps_cover_every_phase_of_the_tabular_step():
    """B2 carries one marker for each phase boundary of a step that the
    tool names, within the stamp buffer's row."""
    stamps = _stamps("tabular_kernel")
    assert tuple(stamps) == tl.stamp_indices("tabular_kernel")
    assert len(stamps) == len(tl.B2_PHASES) + 1 and stamps[-1] < tl.B2_STAMPS[1]


def test_b4_per_update_check_holds_each_update_and_names_the_one_that_parts(monkeypatch):
    """Each update from the plain version's state: on the CPU the wrapper
    runs the plain version, so every update agrees exactly; a fault in one
    update is reported with its index."""
    agent, args = lc.dqn_case("ragged", CPU, torch.Generator().manual_seed(1))
    res = lc.check_b4_per_update(agent, args)
    assert res == {"updates": 8, "max_abs_err": 0.0}
    calls = []
    plain = duk.dqn_update

    def faulty(agent, *a):
        out = plain(agent, *a)
        calls.append(1)
        if len(calls) == 4:
            out = ({k: v + 1e-3 for k, v in out[0].items()},) + tuple(out[1:])
        return out

    monkeypatch.setattr(duk, "dqn_update", faulty)
    with pytest.raises(AssertionError, match="B4 update 3 of 8"):
        lc.check_b4_per_update(agent, args)


def test_b4_beyond_counts_the_entries_past_the_tolerance():
    agent, args = lc.dqn_case("ragged", CPU, torch.Generator().manual_seed(2))
    ref = duk.dqn_update_reference(agent, *args)
    moved = dict(ref[0])
    w1 = moved["w1"].clone()
    w1.view(-1)[:3] += 1.0
    moved["w1"] = w1
    beyond = lc.b4_beyond((moved,) + tuple(ref[1:]), ref)
    assert beyond["0.w1"][0] == 3 and beyond["0.w1"][1] == w1.numel()
    assert all(n == 0 for k, (n, _, _) in beyond.items() if k != "0.w1")
