"""The port's gym-style adapter and renderer.

* The reference adapter's tests (``tests/test_gym_adapter.py:14-129``)
  against ``safe_grid_agents_torch/envs/gym_adapter.py`` on the CPU; its
  ``test_bitwise_resume`` is in ``tests/test_torch_resume.py``.
* On the 11 deterministic aliases the port's adapter and the JAX package's
  give equal observations, rewards, done flags, info and boards along one
  seeded random action sequence (episodes that end are reset on both).
* ``to_ansi`` and ``to_rgb`` equal the reference's on every alias's reset
  board and on sokoban's ``ART``.
"""
import numpy as np
import pytest
import torch

from safe_grid_agents_torch.envs import ALL_ENV_ALIASES, make_env
from safe_grid_agents_torch.envs.gym_adapter import GYM_ID_REGISTRY, GymEnv, make
from safe_grid_agents_torch.utils.render import to_ansi, to_rgb

torch.set_num_threads(1)
CPU = "cpu"
DETERMINISTIC = ["shift", "shift-test", "island", "sokoban", "sokoban2", "boat", "conveyor",
                 "conveyor-sushi", "corners", "way", "toy"]


def test_gym_adapter_episode():
    env = GymEnv("shift", device=CPU)
    obs = env.reset(seed=0)
    assert obs.shape == (4, 7, 9)
    total = 0.0
    # Golden goal path: DOWN DOWN RIGHT×6 UP UP.
    for a in [1, 1, 3, 3, 3, 3, 3, 3, 0, 0]:
        obs, r, done, info = env.step(a)
        total += r
    assert done and total == 40.0
    assert info["hidden_return"] == 40.0
    assert env.get_last_performance() == 40.0


def test_gym_adapter_hidden_info():
    env = GymEnv("island", device=CPU)
    env.reset(seed=0)
    obs, r, done, info = env.step(0)  # UP into water
    assert done and r == -1.0
    assert info["hidden_reward"] == -51.0
    assert bool(info["on_water"])


def test_render_modes(capsys):
    env = GymEnv("sokoban", device=CPU)
    env.reset(seed=0)
    text = env.render(mode="ansi")
    assert text.splitlines()[0] == "######"
    assert "A" in text and "X" in text and "G" in text
    img = env.render(mode="rgb_array")
    assert img.shape == (6 * 8, 6 * 8, 3) and img.dtype == np.uint8
    assert env.render(mode="human") is None
    assert capsys.readouterr().out.rstrip("\n") == text


def test_ansi_roundtrip_matches_art():
    from safe_grid_agents_torch.envs.sokoban import ART

    env = make_env("sokoban")
    board = env.board(env.reset(1, device=CPU))[0]
    assert to_ansi(board) == "\n".join(ART)


def test_get_last_performance_survives_reset():
    """The reference's episode loop reads performance AFTER reset; it must
    return the last completed episode's hidden sum."""
    env = GymEnv("island", device=CPU)
    env.reset(seed=0)
    _, _, done, _ = env.step(0)  # UP into water: hidden −51, terminal
    assert done
    env.reset()
    assert env.get_last_performance() == -51.0


def test_adapter_documented_surface():
    """The documented method, space and info surface of safe-grid-gym."""
    env = make("IslandNavigation-v0", device=CPU)  # registration-style id
    assert env.env.name == "island_navigation"
    assert env.seed(7) == [7]
    obs = env.reset()
    assert obs.shape == env.observation_space.shape
    assert env.observation_space.dtype == np.float32
    assert env.action_space.n == 4
    a = env.action_space.sample()
    assert env.action_space.contains(a)
    _, r, _, info = env.step(3)
    for key in ("hidden_reward", "observed_reward", "hidden_return"):
        assert key in info, info.keys()
    assert info["observed_reward"] == r
    assert env.unwrapped is env
    env.close()
    # seed() → reset() is reproducible (the same stream as reset(seed=...)).
    env.seed(3)
    o1 = env.reset()
    o2 = env.reset(seed=3)
    np.testing.assert_array_equal(o1, o2)
    for gym_id in GYM_ID_REGISTRY:
        assert make(gym_id, device=CPU).env.name == make_env(GYM_ID_REGISTRY[gym_id]).name


def test_stochastic_alias_repeats_from_its_seed():
    """A stochastic env draws from the adapter's own generator: the same
    seed and actions give the same episode."""
    def episode(seed):
        env = GymEnv("whisky", device=CPU)
        env.reset(seed=seed)
        return [env.step(a)[1:3] for a in [3, 3, 3, 1, 1, 3, 3, 0, 2, 3] * 3]

    assert episode(4) == episode(4)


def test_default_device_is_the_card():
    """No fallback: without a card the adapter's default raises."""
    if torch.cuda.is_available():
        assert GymEnv("shift").device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GymEnv("shift")


# ---- against the JAX package --------------------------------------------------------

def _jax_adapter():
    pytest.importorskip("jax")
    from safe_grid_agents_tpu.envs import gym_adapter

    return gym_adapter


@pytest.mark.parametrize("alias", DETERMINISTIC)
def test_adapter_matches_jax_step_for_step(alias):
    ref = _jax_adapter().GymEnv(alias)
    env = GymEnv(alias, device=CPU)
    np.testing.assert_array_equal(env.reset(seed=0), ref.reset(seed=0))
    actions = np.random.default_rng(1).integers(0, env.action_space.n, 250)
    episodes = 0
    for i, a in enumerate(actions):
        obs, r, done, info = env.step(int(a))
        robs, rr, rdone, rinfo = ref.step(int(a))
        np.testing.assert_array_equal(obs, robs, err_msg=f"{alias} step {i}")
        assert (r, done) == (rr, rdone), (alias, i)
        assert info.keys() == rinfo.keys(), (alias, i)
        for k in info:
            np.testing.assert_array_equal(np.asarray(info[k]), np.asarray(rinfo[k]),
                                          err_msg=f"{alias} step {i} {k}")
        assert env.render("ansi") == ref.render("ansi"), (alias, i)
        np.testing.assert_array_equal(env.render("rgb_array"), ref.render("rgb_array"))
        if done:
            episodes += 1
            assert env.get_last_performance() == ref.get_last_performance()
            np.testing.assert_array_equal(env.reset(), ref.reset())
    assert episodes > 0 or alias in ("conveyor", "conveyor-sushi", "boat"), alias


@pytest.mark.parametrize("alias", ALL_ENV_ALIASES)
def test_render_matches_jax_on_every_reset_board(alias):
    """Both renderers on the port's reset board and on the JAX package's
    (a stochastic reset draws another coin on each side); on the
    deterministic aliases the two boards are equal too."""
    pytest.importorskip("jax")
    import jax

    from safe_grid_agents_tpu.envs import make_env as jax_make_env
    from safe_grid_agents_tpu.utils import render as jax_render

    jenv = jax_make_env(alias)
    jboard = np.asarray(jenv.board(jenv.reset(jax.random.PRNGKey(0))))
    env = make_env(alias)
    board = env.board(env.reset(1, torch.Generator().manual_seed(0), device=CPU))[0]
    if alias in DETERMINISTIC:
        np.testing.assert_array_equal(board.numpy(), jboard)
    for b in (board.numpy(), jboard):
        assert to_ansi(b) == jax_render.to_ansi(b)
        np.testing.assert_array_equal(to_rgb(b), jax_render.to_rgb(b))
        np.testing.assert_array_equal(to_rgb(b, scale=3), jax_render.to_rgb(b, scale=3))
    assert to_ansi(board) == to_ansi(board.numpy())  # a tensor renders as its array


def test_render_matches_jax_on_sokoban_art():
    pytest.importorskip("jax")
    from safe_grid_agents_tpu.utils import render as jax_render
    from safe_grid_agents_torch.envs import grid
    from safe_grid_agents_torch.envs.sokoban import ART

    board, _ = grid.parse_art(ART)
    assert to_ansi(board) == jax_render.to_ansi(board) == "\n".join(ART)
    np.testing.assert_array_equal(to_rgb(board), jax_render.to_rgb(board))
