"""Carry state between the JAX package and the port, as numpy arrays.

The port never imports JAX: a caller holding JAX arrays passes
``np.asarray(x)`` in and gets numpy arrays back, so one computation can run
in both packages from identical inputs. Four kinds of state cross:

* tabular-Q state — ``q [S, A]`` f32 and the global step counter, and Q in
  the JAX fused tabular kernels' layout ``qT [A_pad, S_pad]``;
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

The array engine's ``VecState`` crosses as its env state record's fields
(a dict of numpy arrays, by the JAX record's field names) and the episode
accounting ``(ep_return, ep_hidden, ep_len)``; the JAX state's per-lane keys
do not cross (the port draws from a ``torch.Generator``, or takes the
draws the keys give, handed over).

A DQN replay ring crosses as the JAX ring's parts (``ring_from_jax``): its
storage as nested dicts of numpy arrays by the JAX record's field names
(``state``/``next_state`` a ``TableState``'s ``idx``, ``t`` for the compact
ring, or an env state record's fields with ``state_cls``), the write index,
the fill level and, for a prioritized ring, its ``[capacity]``
priorities.

For the deep agents the optax Adam state crosses too: ``optax.adam``'s
``ScaleByAdamState(count, mu, nu)`` over the Q-net's pytree (its ``mu`` and
``nu`` convert as parameters do, ``qnet_params_from_flax``), and the base
PPO optimizer's ``opt_state[1]`` over the actor-critic's pytree, whose
moments the port keeps flat (``ac_moments_to_flat``).

For PPO three more cross:

* actor-critic parameters of all four nets (MLP, table-folded, fused,
  CNN): the port keeps flax's names and layouts, its dict keys joining the
  levels of the flax pytree with ``.`` (``Dense_0.kernel``, ``w1``,
  ``Conv_0.kernel`` in HWIO, …);
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

from .agents.crmdp import CRMDPState
from .agents.dqn import DQNState
from .agents.ppo import PPOState
from .agents.tabular import TabularQState
from .device import resolve_device
from .envs.array_vec import VecState
from .utils import replay

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


def q_to_kernel_layout(q, a_pad: int, s_pad: int) -> np.ndarray:
    """``[S, A]`` Q → the JAX fused tabular kernels' zero-padded
    ``qT [A_pad, S_pad]``."""
    q = q.detach().cpu().numpy() if isinstance(q, torch.Tensor) else np.asarray(q)
    S, A = q.shape
    qT = np.zeros((a_pad, s_pad), np.float32)
    qT[:A, :S] = q.T
    return qT


def q_from_kernel_layout(qT, S: int, A: int, device=None) -> torch.Tensor:
    """Inverse of ``q_to_kernel_layout`` (the pad rows and columns are dropped)."""
    dev = resolve_device(device)
    return torch.as_tensor(np.ascontiguousarray(np.asarray(qT, np.float32)[:A, :S].T),
                           device=dev)


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


def array_vec_state_from_jax(state_cls, fields: Dict[str, np.ndarray], ep_return, ep_hidden,
                             ep_len, device=None) -> VecState:
    """A JAX array-engine ``VecState``'s parts as numpy (the env record's
    fields by name, the episode accounting) → the port's ``VecState`` with
    an env record of ``state_cls``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    return VecState(env=state_cls(**{k: t(v) for k, v in fields.items()}),
                    ep_return=t(ep_return), ep_hidden=t(ep_hidden), ep_len=t(ep_len))


def array_vec_state_to_numpy(vstate: VecState):
    """``(env fields, ep_return, ep_hidden, ep_len)`` as numpy."""
    import dataclasses

    env = {f.name: getattr(vstate.env, f.name).cpu().numpy()
           for f in dataclasses.fields(vstate.env)}
    return (env,) + tuple(x.cpu().numpy() for x in (vstate.ep_return, vstate.ep_hidden,
                                                    vstate.ep_len))


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


def ring_from_jax(storage, idx, size, priorities=None, state_cls=None,
                  device=None) -> replay.BufferState:
    """A JAX replay ring's parts as numpy → the port's ring: the compact
    ``replay.Transition`` ring (``storage["state"]`` and ``["next_state"]``
    hold ``idx`` and ``t``), or with ``state_cls`` an ``Experience`` ring of
    that env state record; ``priorities`` given makes it prioritized."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    rest = {k: t(storage[k]) for k in ("action", "reward", "done")}
    st, nx = storage["state"], storage["next_state"]
    if state_cls is None:
        records = replay.Transition(s_idx=t(st["idx"]), s_t=t(st["t"]), n_idx=t(nx["idx"]),
                                    n_t=t(nx["t"]), **rest)
    else:
        records = replay.Experience(state=state_cls(**{k: t(v) for k, v in st.items()}),
                                    next_state=state_cls(**{k: t(v) for k, v in nx.items()}),
                                    **rest)
    return replay.BufferState(storage=records, idx=int(idx), size=int(size),
                              priorities=None if priorities is None
                              else t(np.asarray(priorities, np.float32)))


def ring_to_numpy(buf: replay.BufferState):
    """``(storage, idx, size, priorities)`` with the storage as nested dicts
    of numpy arrays by the JAX record's field names (``ring_from_jax``'s
    inverse; ``priorities`` is None for a uniform ring)."""
    import dataclasses

    def fields(rec):
        return {f.name: getattr(rec, f.name).cpu().numpy() for f in dataclasses.fields(rec)}

    st = buf.storage
    if isinstance(st, replay.Transition):
        storage = {"state": {"idx": st.s_idx.cpu().numpy(), "t": st.s_t.cpu().numpy()},
                   "next_state": {"idx": st.n_idx.cpu().numpy(), "t": st.n_t.cpu().numpy()}}
    else:
        storage = {"state": fields(st.state), "next_state": fields(st.next_state)}
    storage.update({k: getattr(st, k).cpu().numpy() for k in ("action", "reward", "done")})
    pri = None if buf.priorities is None else buf.priorities.cpu().numpy()
    return storage, buf.idx, buf.size, pri


def dqn_state_from_jax(params, target, count, mu, nu, step, updates, buffer, table: bool,
                       device=None) -> DQNState:
    """A JAX ``DQNState``'s learner parts as numpy (the online and target
    flax pytrees, ``opt_state[0]``'s ``count``, ``mu``, ``nu`` pytrees, the
    env-step and update counters) with the ring ``buffer`` → the port's
    ``DQNState``. ``buffer`` is the port's ``replay.BufferState``, or the
    JAX ring's parts as ``ring_from_jax``'s keyword arguments (a dict with
    ``storage``, ``idx``, ``size`` and, for a prioritized ring,
    ``priorities``)."""
    dev = resolve_device(device)
    if isinstance(buffer, dict):
        buffer = ring_from_jax(device=dev, **buffer)

    def counter(x):
        return torch.tensor(int(x), dtype=torch.int64, device=dev)

    return DQNState(params=qnet_params_from_flax(params, table, dev),
                    target_params=qnet_params_from_flax(target, table, dev),
                    mu=qnet_params_from_flax(mu, table, dev),
                    nu=qnet_params_from_flax(nu, table, dev), count=counter(count),
                    buffer=buffer, step=counter(step), updates=counter(updates))


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


def ac_moments_to_flat(tree) -> np.ndarray:
    """An Adam moment pytree over an actor-critic's params (numpy leaves,
    ``{"params": {...}}``) → the port's flat vector (sorted names, the order
    of ``ravel_pytree``)."""
    p = ac_params_from_flax(tree, "cpu")
    return np.concatenate([p[k].numpy().reshape(-1) for k in sorted(p)]).astype(np.float32)


def ppo_state_to_numpy(astate: PPOState):
    """``(params pytree, count, mu, nu, step)`` as numpy and ints."""
    return (ac_params_to_flax(astate.params), int(astate.count),
            astate.mu.detach().cpu().numpy(), astate.nu.detach().cpu().numpy(),
            int(astate.step))


def crmdp_state_from_jax(tree, count, mu, nu, step, corruption, device=None):
    """A fast-mode JAX ``CRMDPState``'s parts (``ppo_state_from_jax``'s and
    the ``[S]`` corruption table) as numpy → the port's ``CRMDPState``."""
    base = ppo_state_from_jax(tree, count, mu, nu, step, device)
    return CRMDPState(params=base.params, mu=base.mu, nu=base.nu, count=base.count,
                      step=base.step,
                      corruption=torch.as_tensor(np.array(corruption, np.float32),
                                                 device=base.mu.device))


def crmdp_state_to_numpy(astate):
    """``(params pytree, count, mu, nu, step, corruption)`` as numpy and ints."""
    return ppo_state_to_numpy(astate) + (astate.corruption.detach().cpu().numpy(),)


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
