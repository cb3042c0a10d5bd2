"""safe_grid_agents_torch — the PyTorch/CUDA port of ``safe_grid_agents_tpu``.

A second package beside the JAX one, which stays the reference it is held
against. This slice covers the main path:

* ``envs``     — the shift gridworld (train and test layouts) written batched
                 over a leading lane dimension, its compiled ``[S, A]`` tables
                 (BFS on the CPU) and a ``VecEnv`` over them.
* ``ops``      — hand-written CUDA kernels for Hopper (``csrc/*.cu``), built
                 with nvcc at first use and bound with ctypes, each beside its
                 plain PyTorch version: the T-step rollout and the fused
                 tabular-Q trainer.
* ``agents``   — tabular Q (dense ``[S, A]`` table, linear ε anneal).
* ``training`` — chunk statistics, greedy eval and the fused trainer.
* ``cli``      — ``python -m safe_grid_agents_torch shift tabular-q --compiled
                 --mxu --fused-kernel [--preset]``.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``device="cpu"``, CLI ``--platform cpu``); with no card they raise.
"""

__version__ = "0.1.0"
