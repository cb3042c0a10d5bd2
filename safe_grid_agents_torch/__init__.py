"""safe_grid_agents_torch — the PyTorch/CUDA port of ``safe_grid_agents_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. It has:

* ``envs``     — all 19 gridworld aliases of the JAX registry, written
                 batched over a leading lane dimension, their compiled
                 ``[S, A]`` tables (BFS on the CPU) and a ``VecEnv`` over
                 them, with the stochastic aliases' draws as tensors.
* ``ops``      — hand-written CUDA kernels for Hopper (``csrc/*.cu``), built
                 with nvcc at first use and bound with ctypes, each beside its
                 plain PyTorch version: the deterministic and stochastic
                 rollouts, the fused tabular-Q trainers, the DQN collects and
                 update, the PPO collects and optimize, and the fused
                 actor-critic forward.
* ``agents``   — tabular Q, DQN (table-folded or MLP Q-net, double-Q,
                 n-step), PPO (MLP, table-folded, fused-forward) and PPO-CRMDP.
* ``training`` — chunk statistics, greedy eval, n-step replay windows, the
                 fused tabular-Q, DQN and PPO trainers, the MXU PPO trainer
                 and both PPO-CRMDP trainers.
* ``utils``    — metrics logging and the uniform replay ring.
* ``cli``      — ``python -m safe_grid_agents_torch <env> <agent> ...`` for
                 every combination above; the others are refused naming the
                 ROADMAP item that ports them.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--platform cpu``); with no card they raise.
"""

__version__ = "0.1.0"
