"""safe_grid_agents_torch — the PyTorch/CUDA port of ``safe_grid_agents_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. It covers two paths so far:

* ``envs``     — the shift gridworld (train and test layouts) and sokoban,
                 written batched over a leading lane dimension, their
                 compiled ``[S, A]`` tables (BFS on the CPU) and a
                 ``VecEnv`` over them.
* ``ops``      — hand-written CUDA kernels for Hopper (``csrc/*.cu``), built
                 with nvcc at first use and bound with ctypes, each beside its
                 plain PyTorch version: the T-step rollout, the fused
                 tabular-Q trainer, the DQN collect and the DQN update.
* ``agents``   — tabular Q (dense ``[S, A]`` table, linear ε anneal) and DQN
                 (table-folded or MLP Q-net, uniform replay, double-Q,
                 n-step).
* ``training`` — chunk statistics, greedy eval, n-step replay windows and
                 the fused tabular-Q and DQN trainers.
* ``utils``    — metrics logging and the uniform replay ring.
* ``cli``      — ``python -m safe_grid_agents_torch shift tabular-q
                 --compiled --mxu --fused-kernel [--preset]`` and
                 ``sokoban deep-q --compiled --mxu --fused-kernel ...``.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--platform cpu``); with no card they raise.
"""

__version__ = "0.1.0"
