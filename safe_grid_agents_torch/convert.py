"""Carry state between the JAX package and the port, as numpy arrays.

The port never imports JAX: a caller holding JAX arrays passes
``np.asarray(x)`` in and gets numpy arrays back, so one computation can run
in both packages from identical inputs. Four kinds of state cross:

* tabular-Q state — ``q [S, A]`` f32 and the global step counter;
* the engines' carried 5-tuple ``(idx, t, ep_return, ep_hidden, ep_len)``,
  each ``(1, N)``;
* a compiled env's tables, by the JAX attribute names;
* Q-net parameters — the flax pytree ``{"params": {...}}`` (as nested dicts
  of numpy arrays) against the port's ``{w1, b1, …}`` dict — and the flat
  vectors the JAX DQN trainers keep them in (``ravel_pytree`` order: flax's
  leaves by sorted dict key, each raveled in C order), which is how the
  Adam moments ``mu``/``nu`` of ``optax.adam`` over the flat params cross.

Layer names differ between the two JAX nets: the table net has ``w1``/``b1``
then ``Dense_0 … Dense_{L-1}``; ``QMLP`` has ``Dense_0 … Dense_L``.

For PPO three more cross:

* actor-critic parameters of all three nets (MLP, table-folded, fused):
  the port keeps flax's names, its dict keys joining the levels of the
  flax pytree with ``.`` (``Dense_0.kernel``, ``w1``, …);
* the fast-mode optimizer state ``opt_state[1][0]`` =
  ``ScaleByAdamState(count, mu, nu)`` over the ``ravel_pytree``-flattened
  params. The port's flat vectors use the same order (sorted names), so
  ``mu``/``nu`` cross as they are;
* the tensor layout of the JAX fused optimize kernel
  (``PallasPPOTrainer._to_tensors``): ``w1T [H1, D_pad]``, ``b1 [H1, 1]``,
  ``W2T [H2, H1]``, ``b2 [H2, 1]``, ``H3T [A_pad, H2]`` (row A the value
  head) and ``b3 [A_pad, 1]``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .agents.ppo import PPOState
from .agents.tabular import TabularQState
from .device import resolve_device

ENGINE_DTYPES = (np.int32, np.int32, np.float32, np.float32, np.int32)
TABLE_NAMES = ("next_table", "reward_table", "hidden_table", "done_table",
               "reachable", "obs_table", "board_table")


def tabular_state_from_numpy(q, step, device=None) -> TabularQState:
    dev = resolve_device(device)
    return TabularQState(
        q=torch.as_tensor(np.array(q, np.float32), device=dev),
        step=torch.tensor(int(step), dtype=torch.int64, device=dev),
    )


def tabular_state_to_numpy(astate: TabularQState) -> Tuple[np.ndarray, int]:
    return astate.q.detach().cpu().numpy(), int(astate.step)


def engine_state_from_numpy(state, device=None) -> Tuple[torch.Tensor, ...]:
    """5 arrays of ``N`` or ``(1, N)`` values → 5 ``(1, N)`` tensors."""
    dev = resolve_device(device)
    if len(state) != 5:
        raise ValueError(f"engine state: expected 5 arrays, got {len(state)}")
    return tuple(
        torch.as_tensor(np.array(x, d).reshape(1, -1), device=dev)
        for x, d in zip(state, ENGINE_DTYPES)
    )


def engine_state_to_numpy(state) -> Tuple[np.ndarray, ...]:
    return tuple(x.detach().cpu().numpy() for x in state)


def tables_to_numpy(cenv) -> Dict[str, np.ndarray]:
    """A compiled env's tables (and info tables, as ``info/<key>``)."""
    out = {n: getattr(cenv, n).cpu().numpy() for n in TABLE_NAMES}
    out.update({f"info/{k}": v.cpu().numpy() for k, v in cenv.info_tables.items()})
    return out


def tables_from_numpy(tables: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in tables.items()}


def _qnet_paths(names, table: bool) -> Dict[str, Tuple[str, ...]]:
    """Port parameter name → its path in the flax ``params`` dict."""
    out = {}
    for name in names:
        i = int(name[1:])
        leaf = "kernel" if name[0] == "w" else "bias"
        if table and i == 1:
            out[name] = (name,)
        else:
            out[name] = (f"Dense_{i - 2 if table else i - 1}", leaf)
    return out


def qnet_flat_order(names, table: bool) -> List[str]:
    """Port parameter names in flax's leaf order (sorted dict keys), the
    order of ``ravel_pytree(params)``: ``Dense_0/bias, Dense_0/kernel, …,
    b1, w1`` for the table net."""
    paths = _qnet_paths(names, table)
    return sorted(paths, key=lambda n: paths[n])


def qnet_params_from_flax(tree, table: bool, device=None) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (numpy leaves) → the port's ``{w1, b1, …}``."""
    dev = resolve_device(device)
    p = tree["params"]
    n_layers = len(p) - (1 if table else 0)  # w1 and b1 are two keys of layer 1
    names = [f"{k}{i}" for i in range(1, n_layers + 1) for k in ("w", "b")]
    out = {}
    for name, path in _qnet_paths(names, table).items():
        leaf = p
        for key in path:
            leaf = leaf[key]
        out[name] = torch.as_tensor(np.array(leaf, np.float32), device=dev)
    return out


def qnet_params_to_flax(params: Dict[str, torch.Tensor], table: bool):
    """The port's ``{w1, b1, …}`` → flax ``{"params": {...}}`` of numpy arrays."""
    p: Dict = {}
    for name, path in _qnet_paths(params, table).items():
        node = p
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = params[name].detach().cpu().numpy()
    return {"params": p}


def qnet_params_to_flat(params: Dict[str, torch.Tensor], table: bool) -> np.ndarray:
    """``ravel_pytree`` of the matching flax pytree, as one f32 vector."""
    return np.concatenate([
        params[n].detach().cpu().numpy().reshape(-1) for n in qnet_flat_order(params, table)
    ]).astype(np.float32)


def qnet_params_from_flat(flat, shapes: Dict[str, tuple], table: bool,
                          device=None) -> Dict[str, torch.Tensor]:
    """Inverse of ``qnet_params_to_flat`` for parameters of ``shapes``."""
    dev = resolve_device(device)
    flat = np.asarray(flat, np.float32)
    out, at = {}, 0
    for name in qnet_flat_order(shapes, table):
        size = int(np.prod(shapes[name]))
        out[name] = torch.as_tensor(flat[at:at + size].reshape(shapes[name]).copy(), device=dev)
        at += size
    if at != flat.size:
        raise ValueError(f"flat vector has {flat.size} values, the net {at}")
    return {n: out[n] for n in shapes}


# ---- PPO ---------------------------------------------------------------------

def ac_params_from_flax(tree, device=None) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` of an actor-critic (numpy leaves) → the
    port's ``{"Dense_0.kernel": …, "w1": …}``."""
    dev = resolve_device(device)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[prefix + k] = torch.as_tensor(np.array(v, np.float32), device=dev)

    walk(tree["params"], "")
    return out


def ac_params_to_flax(params: Dict[str, torch.Tensor]):
    """The port's actor-critic params → flax ``{"params": {...}}`` of numpy
    arrays."""
    p: Dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = p
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return {"params": p}


def ppo_state_from_jax(tree, count, mu, nu, step, device=None) -> PPOState:
    """A fast-mode JAX ``PPOState``'s parts (params pytree; ``count``,
    ``mu``, ``nu`` of ``opt_state[1][0]``; ``step``) as numpy → the port's
    ``PPOState``."""
    dev = resolve_device(device)
    return PPOState(
        params=ac_params_from_flax(tree, dev),
        mu=torch.as_tensor(np.array(mu, np.float32), device=dev),
        nu=torch.as_tensor(np.array(nu, np.float32), device=dev),
        count=torch.tensor(int(count), dtype=torch.int64, device=dev),
        step=torch.tensor(int(step), dtype=torch.int64, device=dev),
    )


def ppo_state_to_numpy(astate: PPOState):
    """``(params pytree, count, mu, nu, step)`` as numpy and ints."""
    return (ac_params_to_flax(astate.params), int(astate.count),
            astate.mu.detach().cpu().numpy(), astate.nu.detach().cpu().numpy(),
            int(astate.step))


def ppo_kernel_tensors_from_params(params: Dict[str, torch.Tensor], d_pad: int,
                                   a_pad: int = 8) -> Tuple[np.ndarray, ...]:
    """The table net's params → the JAX fused optimize kernel's 6 tensors."""
    p = {k: v.detach().cpu().numpy() for k, v in params.items()}
    D, H1 = p["w1"].shape
    H2, A = p["Dense_1.kernel"].shape
    w1T = np.zeros((H1, d_pad), np.float32)
    w1T[:, :D] = p["w1"].T
    H3T = np.zeros((a_pad, H2), np.float32)
    H3T[:A] = p["Dense_1.kernel"].T
    H3T[A] = p["Dense_2.kernel"][:, 0]
    b3 = np.zeros((a_pad, 1), np.float32)
    b3[:A, 0] = p["Dense_1.bias"]
    b3[A, 0] = p["Dense_2.bias"][0]
    return (w1T, p["b1"].reshape(H1, 1), np.ascontiguousarray(p["Dense_0.kernel"].T),
            p["Dense_0.bias"].reshape(H2, 1), H3T, b3)


def ppo_params_from_kernel_tensors(tensors, D: int, A: int,
                                   device=None) -> Dict[str, torch.Tensor]:
    """Inverse of ``ppo_kernel_tensors_from_params`` (the pad rows and
    columns are dropped)."""
    dev = resolve_device(device)
    w1T, b1, W2T, b2, H3T, b3 = (np.asarray(t, np.float32) for t in tensors)
    p = {"w1": w1T[:, :D].T, "b1": b1[:, 0], "Dense_0.kernel": W2T.T,
         "Dense_0.bias": b2[:, 0], "Dense_1.kernel": H3T[:A].T, "Dense_1.bias": b3[:A, 0],
         "Dense_2.kernel": H3T[A:A + 1].T, "Dense_2.bias": b3[A:A + 1, 0]}
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in p.items()}
