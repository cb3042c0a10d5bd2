"""Resume, profiling and ``--debug-nans`` in the port's CLI.

Twins of the reference's CLI contract (``tests/test_cli.py:102``, the five
``_resume_twin`` legs at ``:159-220``, ``tests/test_gym_adapter.py:55`` and
``tests/test_tools.py:16``), plus the stochastic fused tabular run (B8's
plain version) and PER on the fused DQN trainer
(``safe_grid_agents_torch/tools/resume_gates.py::TWINS``): a straight run
and a half run resumed to the same length end with bitwise-equal final
checkpoints, every leaf (params, optimizer moments, replay ring with its
write position, fill level and priorities, lanes, the generator's state).
"""
import json
import os

import pytest
import torch

from safe_grid_agents_torch.cli import main as cli_main
from safe_grid_agents_torch.cli.main import run
from safe_grid_agents_torch.tools.resume_gates import TWINS, assert_same_leaves, resume_twin
from safe_grid_agents_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
CPU = ["--platform", "cpu"]


def test_cli_resume(tmp_path):
    """tests/test_cli.py:102: resume continues from the saved chunk with more
    total steps."""
    ckdir = str(tmp_path / "ck")
    argv = ["shift", "tabular-q", "--n-envs", "32", "--steps", "16384", "--chunk-steps",
            "128", "--eval-every", "100", "--eval-steps", "20", "--checkpoint-dir", ckdir,
            "--checkpoint-every", "2"] + CPU
    run(argv)
    assert ckpt.latest_step(ckdir) == 16384 // (128 * 32)
    argv2 = list(argv)
    argv2[argv2.index("16384")] = "32768"
    run(argv2 + ["--resume"])
    assert ckpt.latest_step(ckdir) == 32768 // (128 * 32)


def test_resume_without_checkpoint_dir_is_ignored(capsys):
    """As in the reference: ``--resume`` alone trains from scratch."""
    run(["shift", "tabular-q", "--n-envs", "16", "--steps", "2048", "--chunk-steps", "64",
         "--eval-steps", "10", "--resume"] + CPU)
    assert "resumed" not in capsys.readouterr().out


@pytest.mark.parametrize("name", list(TWINS))
def test_cli_resume_bitwise_twin(tmp_path, name):
    """``resume_gates.resume_twin`` (``chip_smoke.py`` phase 8 runs it on the
    card): the final checkpoints equal leaf by leaf, the final evals equal,
    and the straight run's plain-version calls the half run's plus the
    resumed run's, for ``EXPECT[name]``'s kernels and no other."""
    out = resume_twin(name, tmp_path, "cpu")
    _, _, _, n_chunks = TWINS[name]
    leaves = ckpt.read(tmp_path / "straight", n_chunks)
    assert out["leaves"] == len(leaves)
    if name.startswith("fused dqn"):
        # The ring's host-side write position and fill level travel with it;
        # a uniform ring has no priorities.
        assert isinstance(leaves["0/buffer/idx"], int) and leaves["0/buffer/size"] > 0
        assert (leaves["0/buffer/priorities"] is None) == (name == "fused dqn")


def test_bitwise_resume_tabular_trainer(tmp_path):
    """tests/test_gym_adapter.py:55 on the port's TabularQTrainer: 4 chunks
    straight against 2, a checkpoint, a restore into fresh state and 2 more."""
    from safe_grid_agents_torch.agents.tabular import TabularQAgent
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
    from safe_grid_agents_torch.training import TabularQTrainer

    env = make_env("shift")
    tr = TabularQTrainer(TabularQAgent(env, lr=0.2), ArrayVecEnv(env, 32, "cpu"))

    def advance(astate, vstate, gen, n):
        for _ in range(n):
            astate, vstate, _ = tr.train_chunk(astate, vstate, gen, 64)
        return astate, vstate

    g_ref = torch.Generator().manual_seed(1)
    a_ref, v_ref = advance(*tr.init(generator=torch.Generator().manual_seed(0)), g_ref, 4)
    g1 = torch.Generator().manual_seed(1)
    a1, v1 = advance(*tr.init(generator=torch.Generator().manual_seed(0)), g1, 2)
    ckpt.save(str(tmp_path / "ck"), 2, (a1, v1, g1))
    # Restore into a fresh state and a generator at another position.
    g2 = torch.Generator().manual_seed(99)
    a2, v2, g2 = ckpt.restore(str(tmp_path / "ck"),
                              tr.init(generator=torch.Generator().manual_seed(5)) + (g2,))
    a_res, v_res = advance(a2, v2, g2, 2)
    assert torch.equal(a_ref.q, a_res.q) and torch.equal(a_ref.step, a_res.step)
    for (p, x), (_, y) in zip(ckpt.leaves(v_ref), ckpt.leaves(v_res)):
        assert torch.equal(x, y), p
    assert torch.equal(g_ref.get_state(), g2.get_state())


def test_profile_writes_trace(tmp_path):
    """tests/test_tools.py:16: ``--profile-dir`` writes a trace with events
    (CPU activity here; the card's kernels join it on the card)."""
    trace = tmp_path / "trace"
    run(["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs", "32",
         "--steps", "20480", "--chunk-steps", "128", "--eval-every", "100",
         "--eval-steps", "10", "--profile-dir", str(trace)] + CPU)
    files = sorted(os.listdir(trace))
    assert files == ["chunks_1-3.pt.trace.json"], files
    events = json.loads((trace / files[0]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # The fused tabular kernel's plain version ran in the window.
    assert len(events) > 10 and any("aten::" in n for n in names)


DEBUG_RUN = ["shift", "tabular-q", "--compiled", "--mxu", "--fused-kernel", "--n-envs",
             "32", "--steps", "16384", "--chunk-steps", "128", "--eval-every", "2",
             "--eval-steps", "20", "--lr", "0.2"] + CPU


def test_debug_nans_leaves_a_finite_run_unchanged(tmp_path):
    with_flag = run(DEBUG_RUN + ["--debug-nans", "--checkpoint-dir", str(tmp_path / "a")])
    without = run(DEBUG_RUN + ["--checkpoint-dir", str(tmp_path / "b")])
    assert json.dumps(with_flag) == json.dumps(without)
    assert_same_leaves(ckpt.read(tmp_path / "a", 4), ckpt.read(tmp_path / "b", 4),
                       "--debug-nans")


def test_debug_nans_names_the_leaf(monkeypatch):
    """A chunk whose Q table turns NaN raises at that chunk, naming the
    leaf; without the flag the run goes on."""
    from safe_grid_agents_torch.training import FusedTabularQTrainer

    train_chunk = FusedTabularQTrainer.train_chunk
    calls = []

    def poisoned(self, astate, vstate, generator, n_steps):
        astate, vstate, stats = train_chunk(self, astate, vstate, generator, n_steps)
        calls.append(1)
        if len(calls) == 3:
            astate.q[5, 2] = float("nan")
        return astate, vstate, stats

    monkeypatch.setattr(FusedTabularQTrainer, "train_chunk", poisoned)
    with pytest.raises(FloatingPointError, match=r"chunk 2: .*astate/q"):
        run(DEBUG_RUN + ["--debug-nans"])
    calls.clear()
    run(DEBUG_RUN)
    assert len(calls) == 4


def test_check_finite_names_stats_and_losses():
    from safe_grid_agents_torch.training.common import ChunkStats

    stats = ChunkStats.zero("cpu")
    cli_main.check_finite("chunk 0", stats=stats, losses=[torch.tensor(1.0)])
    with pytest.raises(FloatingPointError, match="losses/1"):
        cli_main.check_finite("chunk 0", stats=stats,
                              losses=[torch.tensor(1.0), torch.tensor(float("inf"))])
    stats.return_sum = torch.tensor(float("nan"))
    with pytest.raises(FloatingPointError, match="eval after chunk 3: .*stats/return_sum"):
        cli_main.check_finite("eval after chunk 3", stats=stats)


def test_table_net_backward_repeats_on_several_threads():
    """The table nets' first layer reads rows of the folded table; the
    gradient of a row read many times is summed in one order whatever the
    CPU thread count, so a multi-threaded run repeats (indexing's own
    backward adds from several threads at once)."""
    from safe_grid_agents_torch.agents.ppo import PPOAgent
    from safe_grid_agents_torch.envs import make_env

    env = make_env("corners", compiled=True, device="cpu")
    agent = PPOAgent(env, net="table")
    params = agent.init("cpu", 0).params
    idx = torch.randint(0, env.num_states, (16384,), generator=torch.Generator().manual_seed(1))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        grads = []
        for _ in range(3):
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            logits, value = agent.net.apply(leaves, idx)
            (logits.square().sum() + value.sum()).backward()
            grads.append({k: v.grad for k, v in leaves.items()})
    finally:
        torch.set_num_threads(threads)
    for g in grads[1:]:
        assert all(torch.equal(g[k], grads[0][k]) for k in g)
