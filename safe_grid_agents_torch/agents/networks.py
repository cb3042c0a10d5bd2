"""Q networks for the deep agents, as ``nn.Module``s.

Counterpart of ``safe_grid_agents_tpu/agents/networks.py::QMLP`` and
``make_table_q``. Both nets hold their weights in flax's layout (a dense
kernel is ``[in, out]``, used as ``x @ w + b``) under the names
``w1, b1, …, w{L+1}, b{L+1}``, so the JAX params convert one to one
(``convert.py``) and the fused update kernel reads them as they are.

* ``QMLP``: observation planes ``[..., P, H, W]`` → Q ``[..., A]``;
  ``relu(O[idx] @ w1 + b1)`` for a compiled env's observation row.
* ``TableQNet``: state indices → Q. It keeps the compiled env's static
  observation table ``O [S, D]`` as a buffer and folds it into the first
  layer, ``relu((O @ w1)[idx] + b1)``; the two associations agree to
  float32 rounding.

A net is a function of its parameters: callers hold the parameters as a
``{name: tensor}`` dict and run ``net.apply(params, x)``
(``torch.func.functional_call``), the way the JAX agent calls
``net.apply(params, x)``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn
from torch.func import functional_call


def param_shapes(d_in: int, hidden: Sequence[int], n_actions: int) -> Dict[str, tuple]:
    """``{name: shape}`` of a ReLU Q net's parameters, in the port's order."""
    dims = [d_in, *hidden, n_actions]
    shapes = {}
    for i in range(len(dims) - 1):
        shapes[f"w{i + 1}"] = (dims[i], dims[i + 1])
        shapes[f"b{i + 1}"] = (dims[i + 1],)
    return shapes


class _ReluQ(nn.Module):
    def __init__(self, d_in: int, n_actions: int, hidden: Sequence[int]):
        super().__init__()
        self.hidden = tuple(hidden)
        self.n_actions = n_actions
        self.d_in = d_in
        for name, shape in param_shapes(d_in, hidden, n_actions).items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.n_layers = len(self.hidden) + 1

    def _trunk(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """Layers ``start..L+1`` on the first layer's output ``x``."""
        for i in range(start, self.n_layers + 1):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers:
                x = torch.relu(x)
        return x

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (x,))

    def init_params(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """flax ``Dense`` defaults: kernels lecun-normal (a normal truncated at
        ±2σ, rescaled to variance 1/fan_in), biases zero. Draws come from
        ``generator`` on the CPU and then move to ``device``."""
        out = {}
        for name, shape in param_shapes(self.d_in, self.hidden, self.n_actions).items():
            t = torch.zeros(shape, dtype=torch.float32)
            if name.startswith("w"):
                std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            out[name] = t.to(device)
        return out


class QMLP(_ReluQ):
    """State-action value head: observation planes → Q[a]."""

    def forward(self, obs: torch.Tensor) -> torch.Tensor:  # obs [..., P, H, W]
        x = obs.reshape(*obs.shape[:-3], -1)
        return self._trunk(x, 1)


class TableQNet(_ReluQ):
    """Table-folded Q net for compiled envs: state indices → Q[a]."""

    def __init__(self, obs_flat: torch.Tensor, n_actions: int, hidden: Sequence[int]):
        super().__init__(obs_flat.shape[1], n_actions, hidden)
        self.register_buffer("obs", obs_flat.to(torch.float32).contiguous())

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        folded = self.obs @ self.w1                     # [S, H1]
        x = torch.relu(folded[idx.long()] + self.b1)
        return self._trunk(x, 2)
