"""Q and actor-critic networks for the deep agents, as ``nn.Module``s.

Counterpart of ``safe_grid_agents_tpu/agents/networks.py``. Every net holds
its weights in flax's layout (a dense kernel is ``[in, out]``, used as
``x @ w + b``), so the JAX params convert one to one (``convert.py``) and
the fused kernels read them as they are.

* ``QMLP``: observation planes ``[..., P, H, W]`` → Q ``[..., A]``;
  ``relu(O[idx] @ w1 + b1)`` for a compiled env's observation row.
* ``TableQNet``: state indices → Q. It keeps the compiled env's static
  observation table ``O [S, D]`` as a buffer and folds it into the first
  layer, ``relu((O @ w1)[idx] + b1)``; the two associations agree to
  float32 rounding. The Q nets name their layers ``w1, b1, …, w{L+1},
  b{L+1}``.
* ``ActorCriticMLP``: planes → (logits ``[..., A]``, value ``[...]``), a
  tanh trunk with a logits head and a value head.
* ``TableActorCritic``: the table-folded actor-critic over state indices.
* ``ActorCriticCNN``: planes → (logits, value) through two 3×3 "SAME"
  convolutions (32, then 64 channels) with ReLU, a flatten in flax's
  channels-last order, ``Dense(hidden)`` with ReLU and the two heads.

The actor-critics keep flax's own parameter names, with ``.`` joining the
levels of flax's nested dict: ``Dense_i.kernel`` / ``Dense_i.bias`` (and
``w1``, ``b1`` for the folded first layer, ``Conv_i.kernel`` /
``Conv_i.bias`` for the CNN's convolutions, whose kernels keep flax's HWIO
layout ``[3, 3, C_in, C_out]``). Sorted, those names are the
leaf order of ``ravel_pytree``, which is how the flat optimizer state of
the PPO trainers lines up with the JAX package's.

A net is a function of its parameters: callers hold the parameters as a
``{name: tensor}`` dict and run ``net.apply(params, x)``
(``torch.func.functional_call``), the way the JAX agent calls
``net.apply(params, x)``.

Under tensor parallelism (``parallel/tp.py``) a copy of the net computes
its dense layers on this rank's shards of their parameters: a ``Dense``
whose ``shard`` is set, and a Q net's layer ``i`` in ``shards``, call it
as ``shard(x, kernel, bias)`` in place of ``x @ kernel + bias``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` on the CPU: a normal truncated at ±2σ,
    rescaled to variance 1/fan_in. fan_in is the product of every dimension
    but the last: a dense kernel's ``shape[0]``, an HWIO convolution
    kernel's ``3·3·C_in`` (flax's input axis times its receptive field)."""
    t = torch.zeros(shape, dtype=torch.float32)
    std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return t


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
        self.shards = {}  # layer index -> sharded product (parallel/tp.py)

    def _trunk(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """Layers ``start..L+1`` on the first layer's output ``x``."""
        for i in range(start, self.n_layers + 1):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            x = self.shards[i](x, w, b) if i in self.shards else x @ w + b
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
            t = (lecun_normal(shape, generator) if name.startswith("w")
                 else torch.zeros(shape, dtype=torch.float32))
            out[name] = t.to(device)
        return out


class QMLP(_ReluQ):
    """State-action value head: observation planes → Q[a]."""

    def forward(self, obs: torch.Tensor) -> torch.Tensor:  # obs [..., P, H, W]
        x = obs.reshape(*obs.shape[:-3], -1)
        return self._trunk(x, 1)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` whose backward sums a repeated row's gradients in a
    fixed order on either device, so that a run repeats bit for bit: on the
    CPU through ``index_select`` (its backward, ``index_add_``, walks the
    indices in order, where indexing's own backward adds them from several
    threads at once), on the card through indexing (its backward sorts the
    indices and sums each run of equal ones in order, where ``index_add_``
    adds with atomics)."""
    idx = idx.long()
    if table.device.type != "cpu":
        return table[idx]
    return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


class TableQNet(_ReluQ):
    """Table-folded Q net for compiled envs: state indices → Q[a]."""

    def __init__(self, obs_flat: torch.Tensor, n_actions: int, hidden: Sequence[int]):
        super().__init__(obs_flat.shape[1], n_actions, hidden)
        self.register_buffer("obs", obs_flat.to(torch.float32).contiguous())

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        folded = self.obs @ self.w1                     # [S, H1]
        x = torch.relu(_rows(folded, idx) + self.b1)
        return self._trunk(x, 2)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel [in, out]``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.shard = None  # the sharded product (parallel/tp.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shard is not None:
            return self.shard(x, self.kernel, self.bias)
        return x @ self.kernel + self.bias


class ActorCriticNet(nn.Module):
    """Base of the actor-critics: the functional ``apply``, flax's init and
    the shared tanh trunk → (logits, value) head; the subclasses differ in
    how the first layer meets the input."""

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor):
        return functional_call(self, params, (x,))

    def init_params(self, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
        """flax defaults: kernels (``kernel``, ``w*``) lecun-normal, biases
        zero, drawn from ``generator`` on the CPU in sorted-name order, then
        moved to ``device``."""
        out = {}
        for name, p in sorted(self.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            t = (lecun_normal(tuple(p.shape), generator)
                 if leaf == "kernel" or leaf.startswith("w")
                 else torch.zeros(tuple(p.shape), dtype=torch.float32))
            out[name] = t.to(device)
        return out

    def _head(self, x: torch.Tensor):
        """Hidden layers ``Dense_0 … Dense_{depth-1}``, then the two heads."""
        n = self.depth
        for i in range(n):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        logits = getattr(self, f"Dense_{n}")(x)
        value = getattr(self, f"Dense_{n + 1}")(x).squeeze(-1)
        return logits, value


class ActorCriticMLP(ActorCriticNet):
    """Shared-trunk actor-critic over flattened planes: ``Dense_0 …
    Dense_{L-1}`` hidden, ``Dense_L`` logits, ``Dense_{L+1}`` value."""

    def __init__(self, d_in: int, n_actions: int, hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.hidden = tuple(hidden)
        self.depth = len(self.hidden)
        dims = [d_in, *self.hidden]
        for i in range(len(self.hidden)):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1]))
        self.add_module(f"Dense_{len(self.hidden)}", Dense(dims[-1], n_actions))
        self.add_module(f"Dense_{len(self.hidden) + 1}", Dense(dims[-1], 1))

    def forward(self, obs: torch.Tensor):  # obs [..., P, H, W]
        return self._head(obs.reshape(*obs.shape[:-3], -1))


class TableActorCritic(ActorCriticNet):
    """Table-folded actor-critic for compiled envs: state indices →
    (logits, value). Layer 1 is ``w1, b1`` folded with the observation
    table, ``tanh((O @ w1)[idx] + b1)``; then ``Dense_0 … Dense_{L-2}``
    hidden, ``Dense_{L-1}`` logits, ``Dense_L`` value (the names of
    ``make_table_actor_critic``'s flax params)."""

    def __init__(self, obs_flat: torch.Tensor, n_actions: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.hidden = tuple(hidden)
        self.depth = len(self.hidden) - 1
        dims = list(hidden)
        self.w1 = nn.Parameter(torch.zeros(obs_flat.shape[1], dims[0]))
        self.b1 = nn.Parameter(torch.zeros(dims[0]))
        for i in range(len(dims) - 1):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1]))
        self.add_module(f"Dense_{len(dims) - 1}", Dense(dims[-1], n_actions))
        self.add_module(f"Dense_{len(dims)}", Dense(dims[-1], 1))
        self.register_buffer("obs", obs_flat.to(torch.float32).contiguous())

    def forward(self, idx: torch.Tensor):
        folded = self.obs @ self.w1                     # [S, H1]
        return self._head(torch.tanh(_rows(folded, idx) + self.b1))


def _fp32_convs(x: torch.Tensor):
    """cuDNN's TF32 off for a CUDA tensor's convolutions (nothing on the
    CPU). PyTorch lets cuDNN round float32 convolutions to TF32 by default
    (``torch.backends.cudnn.allow_tf32``), about 1e-3 relative; the
    reference computes them in float32."""
    if x.device.type != "cuda":
        return contextlib.nullcontext()
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=False)


class _Conv3x3(torch.autograd.Function):
    """``F.conv2d(x, w, b, padding=1)`` with ``_fp32_convs`` around the
    forward and the backward pass: the backward reads cuDNN's flags when it
    runs, outside any scope the forward sets, so it takes its own."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _fp32_convs(x):
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with _fp32_convs(x):
            return torch.ops.aten.convolution_backward(
                grad, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                list(ctx.needs_input_grad))


class Conv(nn.Module):
    """flax ``nn.Conv(c_out, (3, 3), padding="SAME")`` on ``[B, C, H, W]``
    planes in float32, its kernel kept in flax's HWIO layout
    ``[3, 3, C_in, C_out]``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Conv3x3.apply(x, self.kernel.permute(3, 2, 0, 1), self.bias)


class ActorCriticCNN(ActorCriticNet):
    """Conv trunk over the observation planes: ``Conv_0`` (32) and
    ``Conv_1`` (64), each 3×3 "SAME" with ReLU; the trunk's output is
    flattened channels-last (``[H, W, C]``, the reference's NHWC order, so a
    converted ``Dense_0.kernel`` keeps its meaning), then ``Dense_0``
    (``hidden``, ReLU), ``Dense_1`` logits and ``Dense_2`` value."""

    def __init__(self, obs_shape, n_actions: int, hidden: int = 128,
                 channels: Sequence[int] = (32, 64)):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        P, H, W = self.obs_shape
        dims = [P, *channels]
        for i in range(len(channels)):
            self.add_module(f"Conv_{i}", Conv(dims[i], dims[i + 1]))
        self.n_convs = len(channels)
        self.Dense_0 = Dense(H * W * dims[-1], hidden)
        self.Dense_1 = Dense(hidden, n_actions)
        self.Dense_2 = Dense(hidden, 1)

    def forward(self, obs: torch.Tensor):  # obs [..., P, H, W]
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + self.obs_shape)
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(self.Dense_0(x))
        logits = self.Dense_1(x)
        value = self.Dense_2(x).squeeze(-1)
        return logits.reshape(lead + logits.shape[-1:]), value.reshape(lead)
