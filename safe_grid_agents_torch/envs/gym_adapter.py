"""Classic gym-style adapter: one env, host-side numpy API.

Counterpart of ``safe_grid_agents_tpu/envs/gym_adapter.py`` (the reference
``safe_grid_gym.GridworldEnv``), for users of the reference who want
``reset()/step()/render()`` unchanged:

    env = GymEnv("sokoban", device="cpu")       # alias construction
    env = make("SideEffectsSokoban-v0")         # registration-style id (cuda:0)
    env.seed(0)                                  # classic gym seeding
    obs = env.reset()                            # (or reset(seed=0))
    obs, reward, done, info = env.step(1)
    info["hidden_reward"]; info["observed_reward"]   # documented info keys
    print(env.render(mode="ansi"))
    env.get_last_performance()                   # last episode's hidden sum

It steps the port's env at N = 1 on ``device`` (``cuda:0`` by default, with
no fallback; ``device="cpu"`` off the card), drawing a stochastic env's
randomness from the adapter's own ``torch.Generator``. Training should use
the engines and trainers; this is a convenience shim so that reference
experiment scripts port 1:1.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.render import to_ansi, to_rgb
from . import make_env


class _DiscreteSpace:
    """Minimal gym.spaces.Discrete stand-in (gym is not a dependency)."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self._rng = rng

    def sample(self) -> int:
        return int(self._rng.integers(self.n))

    def contains(self, a) -> bool:
        return 0 <= int(a) < self.n


class _BoxSpace:
    """Minimal gym.spaces.Box stand-in for the one-hot plane observation."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.low, self.high = 0.0, 1.0
        self.dtype = np.float32


def _lane(x: torch.Tensor) -> np.ndarray:
    return x[0].detach().cpu().numpy()


class GymEnv:
    metadata = {"render.modes": ["ansi", "rgb_array", "human"]}

    def __init__(self, alias: str, device=None, **kwargs):
        self.device = resolve_device(device)
        self.env = make_env(alias, **kwargs)
        self._np_rng = np.random.default_rng(0)
        self.action_space = _DiscreteSpace(self.env.n_actions, self._np_rng)
        self.observation_space = _BoxSpace(self.env.obs_shape)
        # Attributes of the reference's first surface.
        self.action_space_n = self.env.n_actions
        self.observation_shape = self.env.obs_shape
        self._state = None
        self._generator: Optional[torch.Generator] = None
        self._episode_hidden = 0.0
        self._last_performance = 0.0  # the last COMPLETED episode's hidden sum

    def seed(self, seed: Optional[int] = None):
        """Classic gym seeding: fixes the env's random stream for later
        resets and steps. Returns the seed list of the classic contract."""
        seed = 0 if seed is None else int(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self.action_space._rng = self._np_rng
        return [seed]

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None or self._generator is None:
            self.seed(seed)
        self._state = self.env.reset(1, self._generator, device=self.device)
        self._episode_hidden = 0.0
        return _lane(self.env.observe(self._state))

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        assert self._state is not None, "call reset() first"
        act = torch.full((1,), int(action), dtype=torch.int32, device=self.device)
        out = self.env.step(self._state, act, self._generator)
        self._state = out.state
        hidden, reward, done = float(out.hidden_reward[0]), float(out.reward[0]), bool(out.done[0])
        self._episode_hidden += hidden
        if done:
            self._last_performance = self._episode_hidden
        info = {k: _lane(v) for k, v in out.info.items()}
        info["hidden_reward"] = hidden
        info["observed_reward"] = reward
        info["hidden_return"] = self._episode_hidden
        return _lane(self.env.observe(self._state)), reward, done, info

    # The reference's env.get_last_performance(): the LAST COMPLETED
    # episode's hidden performance; it survives reset(), so the usual "step
    # to done → reset → read performance" loop works.
    def get_last_performance(self) -> float:
        return self._last_performance

    def render(self, mode: str = "ansi"):
        assert self._state is not None, "call reset() first"
        board = _lane(self.env.board(self._state))
        if mode == "rgb_array":
            return to_rgb(board)
        text = to_ansi(board)
        if mode == "human":
            print(text)
            return None
        return text

    def close(self):
        """Classic gym teardown hook (nothing to release here)."""

    @property
    def unwrapped(self):
        return self


# Registration-style construction: the gym ids safe-grid-gym registers,
# mapped onto the aliases, so that ``gym.make("...")``-style scripts port
# by swapping the import.
GYM_ID_REGISTRY: Dict[str, str] = {
    "DistributionalShift-v0": "shift",
    "IslandNavigation-v0": "island",
    "SideEffectsSokoban-v0": "sokoban",
    "BoatRace-v0": "boat",
    "TomatoWatering-v0": "tomato",
    "TomatoCrmdp-v0": "tomato-crmdp",
    "WhiskyGold-v0": "whisky",
    "AbsentSupervisor-v0": "absent",
    "SafeInterruptibility-v0": "interrupt",
    "ConveyorBelt-v0": "conveyor",
    "ConveyorBeltSushi-v0": "conveyor-sushi",
    "FriendFoe-v0": "friend",
    "ToyGridworldUncorrupted-v0": "toy",
    "ToyGridworldCorners-v0": "corners",
    "ToyGridworldOnTheWay-v0": "way",
}


def make(env_id: str, device=None, **kwargs) -> GymEnv:
    """``gym.make``-style constructor: a registered gym id
    (``"IslandNavigation-v0"``) or a bare alias (``"island"``)."""
    return GymEnv(GYM_ID_REGISTRY.get(env_id, env_id), device=device, **kwargs)
