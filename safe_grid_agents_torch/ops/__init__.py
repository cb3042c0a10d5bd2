"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``rollout_kernel``  — T-step rollout of a compiled env (csrc/rollout_kernel.cu)
* ``tabular_kernel``  — fused tabular-Q training (csrc/tabular_kernel.cu)
* ``dqn_kernel``      — fused DQN collect (csrc/dqn_kernel.cu)
* ``dqn_update_kernel`` — fused DQN update: U sampled TD updates with Adam
  (csrc/dqn_update_kernel.cu on one cluster; csrc/dqn_update_grid.cu, one
  cooperative launch over every SM, for nets or batches a cluster cannot
  hold), its tiled products in csrc/tile_gemm.cuh (mirrored by ``tile_gemm``)
* ``stoch_rollout_kernel`` — T-step rollout of a stochastic compiled env
  (csrc/stoch_rollout_kernel.cu, sharing csrc/stoch_step.cuh)
* ``tabular_stoch_kernel`` — fused tabular-Q training on a stochastic env
  (csrc/tabular_stoch_kernel.cu)
* ``dqn_stoch_kernel``, ``ppo_stoch_collect_kernel`` — the DQN and PPO
  collects on a stochastic env (csrc/dqn_stoch_kernel.cu,
  csrc/ppo_stoch_collect_kernel.cu)
* ``ppo_collect_kernel``, ``ppo_kernel``, ``fused_mlp`` — PPO collect, the
  PPO optimize (csrc/ppo_kernel.cu; csrc/ppo_wide_kernel.cu, over
  csrc/tile_gemm.cuh, for hidden widths above 128 or more than 7 actions)
  and the actor-critic forward

A wrapper launches its kernel for CUDA tensors (or raises) and runs the plain
version only for CPU tensors. Each module keeps a ``LaunchCounts``: the
wrapper adds one to ``launches`` where it launches the kernel, the plain
version adds one to ``plain_calls`` per call, so a run can show which of the
two carried it. A module with two kernel routes keeps a ``LaunchCounts`` for
each.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LaunchCounts:
    launches: int = 0     # kernel launches by the wrapper
    plain_calls: int = 0  # calls of the plain PyTorch version

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
