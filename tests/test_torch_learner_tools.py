"""The learner tools' CPU-side parts: the cases they build, the phase
stamp markers in the two sources that the trace tool turns on, the
CPU-stream context of the whisky check, and the parity helpers, on the CPU
(the kernels themselves run only on a card: tests/test_torch_kernels_gpu.py)."""
import re

import pytest
import torch

from safe_grid_agents_torch.ops import _build
from safe_grid_agents_torch.ops import dqn_update_kernel as duk
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


def test_cpu_streams_makes_cpu_generators_and_restores_torch():
    rand, gen = torch.rand, torch.Generator
    with ws.cpu_streams():
        g = torch.Generator(device="cuda")
        assert g.device.type == "cpu"
        g.manual_seed(3)
        x = torch.rand(4, generator=g, device="cpu")
    assert torch.rand is rand and torch.Generator is gen
    assert torch.equal(x, torch.rand(4, generator=torch.Generator().manual_seed(3)))
