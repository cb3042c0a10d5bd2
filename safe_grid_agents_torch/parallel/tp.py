"""Tensor parallelism over the grid's ``model`` axis, with data parallelism
over ``data``: the CLI's ``--tp``.

Counterpart of ``safe_grid_agents_tpu/parallel/tp.py``. The reference
places the parameters with ``NamedSharding``s and lets GSPMD partition the
unmodified single-device program; here every rank is one process, so the
partitioning is written out. The deep nets' dense layers shard
Megatron-style over ``model`` (``tp_param_specs``: alternating
column-parallel and row-parallel kernels in layer order, heads replicated),
and each rank of a model group computes its shards' part of every product:

* a column-parallel layer holds ``kernel[:, shard]`` and ``bias[shard]``; its
  replicated input passes ``collectives.copy_to_model`` (whose backward sums
  the input's gradient over ``model``) and its output stays sharded;
* a row-parallel layer holds ``kernel[shard, :]``; it all-reduces its
  partial product over ``model`` (``reduce_from_model``), then adds its
  replicated bias once;
* a replicated layer (a head, a layer narrower than ``min_dim``) that meets
  a column-parallel layer's output gathers it first.

A col→row pair thus costs one all-reduce forward and none backward, and
every replicated quantity (the activations after a row layer, the heads,
their gradients) is bitwise the same on each rank of a model group.
Adam's moments shard like their parameters (PPO's flat moments segment by
segment), the replay ring shards over ``data`` (``DPTrainer``'s ring of
``capacity / D``), and everything else is replicated: ``TPPlan.shard_state``
with ``DPTrainer`` is the counterpart of the reference's ``_leaf_spec``.
Gradients all-reduce over ``data`` only. PPO's clip by the global norm
takes the norm of the whole logical tree: a sharded leaf's squares summed
over ``model``, a replicated leaf's counted once (``TPPlan.sq_norm``).

``TPTrainer(trainer, mesh)`` wraps the array engine's deep trainers
(``DQNTrainer``, ``PPOTrainer`` for ppo-mlp and ppo-cnn, ``CRMDPTrainer``)
with ``DPTrainer``'s surface. At data ``D``, model ``M`` it computes what
``DPTrainer`` at ``W = D`` computes on the same rank generators, and at
``D = 1`` what the unwrapped trainer computes; the difference is only the
float association of the sharded sums. The draws follow ``DPTrainer``'s
rank-seed protocol (a rank's generator is seeded by its data index, so the
ranks of a model group step identical lanes with identical draws), not the
single-device draws of the reference's GSPMD program: the port's trainers
draw from their own ``torch.Generator``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..agents.networks import ActorCriticCNN, ActorCriticNet, TableQNet, _ReluQ
from ..agents.ppo import ravel, unravel
from ..training import CRMDPTrainer, DQNTrainer, PPOTrainer
from .collectives import (
    all_gather_lanes, copy_to_model, gather_from_model, psum, reduce_from_model,
)
from .dp import DPTrainer
from .mesh import MODEL_AXIS, AxisGroup, DataGroup

COL = (None, MODEL_AXIS)      # kernel[:, shard]
COL_BIAS = (MODEL_AXIS,)      # bias[shard] after a column-parallel kernel
ROW = (MODEL_AXIS, None)      # kernel[shard, :]
MOMENTS = ("params", "target_params", "mu", "nu")
TP_TRAINERS = (DQNTrainer, PPOTrainer, CRMDPTrainer)


def _flax_paths(names, table: bool) -> Dict[str, Tuple[str, ...]]:
    """Port parameter name → its path in the reference's flax ``params``:
    the actor-critics keep flax's names (``Dense_0.kernel``, ``w1``), the Q
    nets' ``w{i}``/``b{i}`` are ``Dense_{i-1}`` (``Dense_{i-2}`` after the
    table net's top-level ``w1``/``b1``)."""
    if any("." in n for n in names):
        return {n: tuple(n.split(".")) for n in names}
    out = {}
    for n in names:
        i = int(n[1:])
        leaf = "kernel" if n[0] == "w" else "bias"
        out[n] = (n,) if table and i == 1 else (f"Dense_{i - 2 if table else i - 1}", leaf)
    return out


def tp_param_specs(params, min_dim: int = 8, table: bool = False) -> Dict[str, tuple]:
    """Megatron-style specs of a net's parameters (``{name: tensor}``, the
    port's names; ``table`` for a table-folded Q net).

    Returns ``{name: spec}`` for the sharded leaves, a spec being the
    reference's ``PartitionSpec`` as a tuple: the 2-D kernels (flax's
    ``kernel`` leaves) whose dims are both ≥ ``min_dim`` alternate
    column-parallel ``(None, 'model')`` / row-parallel ``('model', None)``
    in flax's leaf order; the bias after a column kernel is ``('model',)``.
    Heads, every other bias, the table nets' folded ``w1`` and the 4-D
    convolution kernels are replicated (absent from the table)."""
    paths = _flax_paths(list(params), table)
    by_path = {p: n for n, p in paths.items()}
    specs: Dict[str, tuple] = {}
    col = True  # start column-parallel
    for name in sorted(paths, key=paths.get):
        path, shape = paths[name], tuple(params[name].shape)
        if path[-1] != "kernel" or len(shape) != 2 or min(shape) < min_dim:
            continue  # heads and non-dense leaves: replicated
        if col:
            specs[name] = COL
            bias = by_path.get(path[:-1] + ("bias",))
            if bias is not None:
                specs[bias] = COL_BIAS
        else:
            specs[name] = ROW
        col = not col
    return specs


def _layers(net) -> list:
    """``(hook key, module or None, kernel name, role)`` of the net's dense
    layers in forward order; ``role`` "trunk" for a layer that feeds the
    next, "out" for one whose output is the net's (a Q net's last layer,
    the actor-critics' two heads, which share the trunk's output)."""
    if isinstance(net, _ReluQ):
        start = 2 if isinstance(net, TableQNet) else 1  # the table net's fold stays whole
        return [(i, None, f"w{i}", "out" if i == net.n_layers else "trunk")
                for i in range(start, net.n_layers + 1)]
    if isinstance(net, ActorCriticCNN):
        return [(None, net.Dense_0, "Dense_0.kernel", "trunk"),
                (None, net.Dense_1, "Dense_1.kernel", "out"),
                (None, net.Dense_2, "Dense_2.kernel", "out")]
    if isinstance(net, ActorCriticNet) and hasattr(net, "depth"):
        n = net.depth
        return [(None, getattr(net, f"Dense_{i}"), f"Dense_{i}.kernel",
                 "trunk" if i < n else "out") for i in range(n + 2)]
    raise ValueError(f"{type(net).__name__}: no tensor-parallel layout (the deep agents' "
                     "MLP, table and CNN nets have one)")


class ShardedLinear:
    """One dense layer's product on this rank's shards: ``mode`` "col" (a
    replicated input), "row" (a column layer's sharded output) or "rep" (a
    replicated layer after a column layer)."""

    def __init__(self, mode: str, model: AxisGroup):
        self.mode, self.model = mode, model

    def __call__(self, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
        if self.mode == "row":
            return reduce_from_model(x @ kernel, self.model) + bias
        if self.mode == "col":
            return copy_to_model(x, self.model) @ kernel + bias
        return gather_from_model(x, self.model) @ kernel + bias


def _cut(t: torch.Tensor, spec: tuple, model: AxisGroup) -> torch.Tensor:
    """This model rank's block of ``t`` under ``spec`` (``TPPlan`` checked
    that the dim splits)."""
    dim = spec.index(MODEL_AXIS)
    k = t.shape[dim] // model.world_size
    return t.narrow(dim, model.rank * k, k).clone()


class TPPlan:
    """A rank's tensor-parallel plan of one net: the specs, the model group
    and the net's global parameter shapes; it cuts and joins states and
    builds the rank's copy of the net."""

    def __init__(self, net, specs: Dict[str, tuple], model: AxisGroup):
        self.specs, self.model = specs, model
        self.shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
        self.local = {k: self._local_shape(k, s) for k, s in self.shapes.items()}
        self._mask = {}

    def _local_shape(self, name: str, shape: tuple) -> tuple:
        spec = self.specs.get(name)
        if not spec:
            return shape
        dim = spec.index(MODEL_AXIS)
        if shape[dim] % self.model.world_size:
            raise ValueError(f"{name} {shape}: dim {dim} does not split over "
                             f"{self.model.world_size} model ranks")
        return shape[:dim] + (shape[dim] // self.model.world_size,) + shape[dim + 1:]

    def shard_net(self, net):
        """A copy of ``net`` whose dense layers compute on this rank's shards
        (its parameters keep the global shapes: ``init_params`` draws the
        whole net, which ``shard_state`` then cuts)."""
        net = copy.deepcopy(net)
        spec_mode = {COL: "col", ROW: "row"}
        sharded = False  # whether the trunk's activation is cut over ``model``
        shards = {}
        for key, module, kernel, role in _layers(net):
            mode = spec_mode.get(self.specs.get(kernel), "rep")
            if ((mode == "row" and not sharded)
                    or (mode == "col" and (sharded or role == "out"))):
                # A narrow layer between wide ones, or an output at least
                # min_dim wide: no net the CLI builds has these.
                raise ValueError(f"{kernel}: a {mode} layer after a "
                                 f"{'sharded' if sharded else 'replicated'} activation "
                                 f"({role}) has no tensor-parallel layout here")
            if mode != "rep" or sharded:
                hook = ShardedLinear(mode, self.model)
                if module is None:
                    shards[key] = hook
                else:
                    module.shard = hook
            if role == "trunk":
                sharded = mode == "col"
        if isinstance(net, _ReluQ):
            net.shards = shards
        return net

    def shard_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: _cut(v, self.specs[k], self.model) if k in self.specs else v
                for k, v in params.items()}

    def gather_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole parameters from the model group's shards (every rank of
        the group calls it)."""
        return {k: all_gather_lanes(v, self.model, self.specs[k].index(MODEL_AXIS))
                if k in self.specs else v for k, v in params.items()}

    def _map_state(self, astate, params_fn, flat_fn):
        out = {}
        for name in MOMENTS:
            x = getattr(astate, name, None)
            if isinstance(x, dict):
                out[name] = params_fn(x)
            elif isinstance(x, torch.Tensor):  # PPO's flat moments
                out[name] = flat_fn(x)
        return dataclasses.replace(astate, **out)

    def shard_state(self, astate):
        """A learner state of the whole net → this rank's: params, target
        params and Adam's moments cut like their parameters (PPO's flat
        moments segment by segment), every other leaf as it is."""
        return self._map_state(
            astate, self.shard_params,
            lambda flat: ravel(self.shard_params(unravel(flat, self.shapes))))

    def gather_state(self, astate):
        """Inverse of ``shard_state`` over the model group (every rank of the
        group calls it)."""
        return self._map_state(
            astate, self.gather_params,
            lambda flat: ravel(self.gather_params(unravel(flat, self.local))))

    def sq_norm(self, g: torch.Tensor) -> torch.Tensor:
        """Σ g² of the whole gradient from this rank's flat shard ``g``
        (sorted-name order): the sharded leaves' squares summed over
        ``model``, the replicated leaves' counted once."""
        mask = self._mask.get(g.device)
        if mask is None:
            mask = torch.cat([torch.full((math.prod(s),), k in self.specs)
                              for k, s in sorted(self.local.items())]).to(g.device)
            self._mask[g.device] = mask
        sharded, rest = g[mask], g[~mask]
        return psum((sharded * sharded).sum(), self.model) + (rest * rest).sum()


class TPTrainer(DPTrainer):
    """dp×tp wrapper of a deep trainer of the array engine over ``mesh``
    (``make_mesh(n_data, n_model)``); mirrors ``DPTrainer``'s surface (init
    / train_chunk / warmup_chunk / eval_chunk / reset_envs / has_warmup)."""

    def __init__(self, trainer, mesh: DataGroup):
        if type(trainer) not in TP_TRAINERS:
            raise ValueError(f"--tp wraps the array engine's deep trainers (deep-q, ppo-mlp, "
                             f"ppo-cnn, ppo-crmdp), not {type(trainer).__name__}")
        if mesh.model is None:
            raise ValueError("TPTrainer needs a mesh with a model axis (n_model > 1)")
        if getattr(trainer.agent, "net_kind", None) == "pallas":
            raise ValueError("the fused-kernel net (B11) is single-device; use net='mlp'")
        super().__init__(trainer, mesh)
        agent = self.trainer.agent
        params = dict(agent.net.named_parameters())
        self.specs = tp_param_specs(params, table=getattr(agent, "table", False))
        self.plan = TPPlan(agent.net, self.specs, mesh.model)
        local = copy.copy(agent)
        local.net = self.plan.shard_net(agent.net)
        local.tp = self.plan
        if hasattr(agent, "shapes"):
            local.shapes = dict(self.plan.local)
        self.trainer.agent = local

    def init(self, seed: int = 0, generator=None):
        """The whole learner state from ``seed`` cut to this rank's shards,
        this rank's lanes (from ``generator``)."""
        astate, vstate = self.trainer.init(seed=seed, generator=generator)
        return self.plan.shard_state(astate), vstate
