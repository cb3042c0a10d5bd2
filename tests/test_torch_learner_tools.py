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
