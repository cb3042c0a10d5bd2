"""``safe_grid_agents_torch/utils/checkpoint.py``: the port's counterpart of
the reference's orbax checkpoints, on ``torch.save``.

* The reference's round trip (``tests/test_cli.py:88``), and a round trip
  of each trainer's real ``(astate, vstate, generator)``: every leaf
  bitwise, dtypes and devices kept, the generator's state carried, the
  file readable with ``torch.load(..., weights_only=True)``.
* Atomic commits: a step counts only once its file is renamed into place;
  a torn newest file is skipped with the reference's message;
  ``max_to_keep``; ``wait=False`` saves a snapshot, not the live ring
  written in place after it; a structure or shape mismatch raises.
"""
import os

import pytest
import torch

from safe_grid_agents_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


def assert_trees_equal(a, b):
    la, lb = list(ckpt.leaves(a)), list(ckpt.leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert la, "empty tree"
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y), p
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), p
        else:
            assert x == y, p


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_cli.py:88: a nested dict of a float tensor and ints."""
    path = str(tmp_path / "ck")
    state = {"a": torch.arange(5, dtype=torch.float32),
             "b": {"c": torch.tensor(7, dtype=torch.int32), "d": 7}}
    ckpt.save(path, 3, state)
    assert ckpt.latest_step(path) == 3
    zeros = {"a": torch.zeros(5), "b": {"c": torch.zeros((), dtype=torch.int32), "d": 0}}
    restored = ckpt.restore(path, zeros)
    assert torch.equal(restored["a"], torch.arange(5, dtype=torch.float32))
    assert int(restored["b"]["c"]) == 7 and restored["b"]["d"] == 7
    assert restored["b"]["c"].dtype == torch.int32


def _trainer_state(kind: str, seed: int):
    """``(trainer, (astate, vstate, generator))`` after a chunk (and a
    warmup for DQN) from ``seed``."""
    from safe_grid_agents_torch.agents.crmdp import PPOCRMDPAgent
    from safe_grid_agents_torch.agents.dqn import DQNAgent
    from safe_grid_agents_torch.agents.ppo import PPOAgent
    from safe_grid_agents_torch.agents.tabular import TabularQAgent
    from safe_grid_agents_torch.envs import make_env
    from safe_grid_agents_torch.envs.array_vec import ArrayVecEnv
    from safe_grid_agents_torch.envs.vec import VecEnv
    from safe_grid_agents_torch import training as T

    g = torch.Generator().manual_seed(seed)
    dqn_kw = dict(batch_size=32, replay_capacity=512, prioritized=True, double_q=True)
    if kind == "tabular":
        env = make_env("shift")
        tr = T.TabularQTrainer(TabularQAgent(env, lr=0.2), ArrayVecEnv(env, 16, "cpu"))
    elif kind == "tabular absent (array engine)":
        env = make_env("absent")
        tr = T.TabularQTrainer(TabularQAgent(env, lr=0.2), ArrayVecEnv(env, 16, "cpu"))
    elif kind == "fused tabular":
        env = make_env("whisky", compiled=True, device="cpu")
        tr = T.FusedTabularQTrainer(TabularQAgent(env, lr=0.2), VecEnv(env, 16))
    elif kind in ("mxu dqn per", "fused dqn per"):
        env = make_env("sokoban", compiled=True, device="cpu")
        cls = T.MXUDQNTrainer if kind == "mxu dqn per" else T.FusedDQNTrainer
        tr = cls(DQNAgent(env, **dqn_kw), VecEnv(env, 16), updates_per_chunk=4)
    elif kind == "base dqn per":
        env = make_env("sokoban")
        tr = T.DQNTrainer(DQNAgent(env, **dqn_kw), ArrayVecEnv(env, 16, "cpu"),
                          updates_per_chunk=4)
    elif kind == "fused ppo":
        env = make_env("corners", compiled=True, device="cpu")
        tr = T.FusedPPOTrainer(PPOAgent(env, net="table", lr=1e-3), VecEnv(env, 32))
    elif kind == "crmdp":
        env = make_env("corners", compiled=True, device="cpu")
        tr = T.MXUCRMDPTrainer(PPOCRMDPAgent(env, net="table", lr=1e-3), VecEnv(env, 32))
    else:
        raise KeyError(kind)
    if isinstance(tr, (T.TabularQTrainer, T.FusedTabularQTrainer)):
        astate, vstate = tr.init(generator=g)
    else:
        astate, vstate = tr.init(seed=seed, generator=g)
    if hasattr(tr, "warmup_chunk"):
        astate, vstate, _ = tr.warmup_chunk(astate, vstate, g, 16)
    astate, vstate = tr.train_chunk(astate, vstate, g, 32 if "fused tabular" in kind
                                    else 16)[:2]
    return tr, (astate, vstate, g)


KINDS = ["tabular", "tabular absent (array engine)", "fused tabular", "mxu dqn per",
         "fused dqn per", "base dqn per", "fused ppo", "crmdp"]


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_state_roundtrip(tmp_path, kind):
    _, state = _trainer_state(kind, seed=3)
    ckpt.save(tmp_path, 1, state)
    # Restore into another run's state, its generator elsewhere in its stream.
    _, example = _trainer_state(kind, seed=11)
    restored = ckpt.restore(tmp_path, example)
    assert restored[2] is example[2]  # the generator is set in place
    assert_trees_equal(restored, state)
    blob = torch.load(os.path.join(tmp_path, "1", ckpt.FILE), weights_only=True)
    assert blob["step"] == 1 and len(blob["leaves"]) == len(list(ckpt.leaves(state)))
    if "dqn" in kind:
        buf = restored[0].buffer
        assert (buf.idx, buf.size) == (state[0].buffer.idx, state[0].buffer.size)
        assert buf.size > 0 and buf.priorities.dtype == torch.float32
    if kind == "crmdp":
        assert restored[0].corruption.shape == state[0].corruption.shape


def test_restored_run_continues_bitwise(tmp_path):
    """Two more chunks from the restored PER state equal two more from the
    state that was saved."""
    tr, (a, v, g) = _trainer_state("fused dqn per", seed=3)
    ckpt.save(tmp_path, 1, (a, v, g))
    _, example = _trainer_state("fused dqn per", seed=11)
    a2, v2, g2 = ckpt.restore(tmp_path, example)
    for _ in range(2):
        a, v = tr.train_chunk(a, v, g, 16)[:2]
        a2, v2 = tr.train_chunk(a2, v2, g2, 16)[:2]
    assert_trees_equal((a2, v2, g2), (a, v, g))


def test_torn_newest_step_falls_back(tmp_path, capsys):
    path = str(tmp_path)
    for step, value in ((1, 1.0), (2, 2.0)):
        ckpt.save(path, step, {"x": torch.full((64,), value)})
    newest = os.path.join(path, "2", ckpt.FILE)
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    step, state = ckpt.restore_latest_valid(path, {"x": torch.zeros(64)})
    assert step == 1 and torch.equal(state["x"], torch.full((64,), 1.0))
    assert "checkpoint step 2 unreadable (" in capsys.readouterr().out
    assert ckpt.restore_latest_valid(str(tmp_path / "none"), {"x": torch.zeros(1)}) == (
        None, None)


def test_uncommitted_step_is_no_step(tmp_path):
    """A write killed before its rename leaves a temporary file, not a step."""
    ckpt.save(tmp_path, 4, {"x": torch.ones(3)})
    os.makedirs(tmp_path / "8")
    (tmp_path / "8" / f".{ckpt.FILE}.123.456.tmp").write_bytes(b"partial")
    assert ckpt.latest_step(tmp_path) == 4
    assert ckpt.committed_steps(str(tmp_path)) == [4]
    step, _ = ckpt.restore_latest_valid(str(tmp_path), {"x": torch.zeros(3)})
    assert step == 4


def test_max_to_keep(tmp_path):
    for step in range(1, 6):
        ckpt.save(tmp_path, step, {"x": torch.tensor(float(step))}, max_to_keep=2,
                  wait=step == 5)
    assert ckpt.committed_steps(str(tmp_path)) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["4", "5"]


def test_async_save_holds_the_snapshot(tmp_path):
    """``wait=False`` copies the state before it returns: the ring written
    in place right after (as the next chunk's push does) is not what the
    step holds."""
    from safe_grid_agents_torch.utils import replay

    buf = replay.init_like(8, {"x": torch.zeros(1)}, prioritized=True)
    buf = replay.push_batch_prioritized(buf, {"x": torch.arange(3, dtype=torch.float32)})
    snap_x, snap_p = buf.storage["x"].clone(), buf.priorities.clone()
    ckpt.save(tmp_path, 1, buf, wait=False)
    buf = replay.push_batch_prioritized(buf, {"x": torch.full((5,), 9.0)})
    buf.priorities.fill_(3.0)
    ckpt.wait_all()
    saved = ckpt.read(tmp_path, 1)
    assert torch.equal(saved["storage/x"], snap_x) and torch.equal(saved["priorities"], snap_p)
    assert saved["idx"] == 3 and saved["size"] == 3


def test_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.zeros(3), "n": 2})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"x": torch.zeros(4), "n": 0})
    with pytest.raises(ValueError, match="expected None"):
        ckpt.restore(tmp_path, {"x": torch.zeros(3), "n": None})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", {"x": torch.zeros(3)})


def test_unsupported_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="x/0"):
        ckpt.save(tmp_path, 1, {"x": [object()]})
