"""PPO-CRMDP: PPO for corrupt-reward MDPs.

Counterpart of ``safe_grid_agents_tpu/agents/crmdp.py``: online
least-squares corruption attribution. After each rollout chunk the agent
receives only each env's aggregate discrepancy

    resid_i = Σ_t observed_r(i,t) − Σ_t hidden_r(i,t)

and fits a per-state corruption estimate ``c[s]`` by one normalized-LMS
step on ½·Σ_i (Σ_s n_is·c[s] − resid_i)², where ``n_is`` counts env i's
arrivals in state s. Rewards are relabeled ``r′ = r − c[s′]`` (``s′`` the
arrival state) before GAE. States never implicated keep ``c[s] = 0``, so an
uncorrupted env reduces to plain PPO.

The learner state is ``PPOState`` plus the ``[S]`` f32 table. The data-axis
average of the reference's multi-device path is not ported (ROADMAP A.14).

The scatter-add of the normalized errors sums 64-bit fixed-point integers
(2^-32 units, ``CORR_SCALE``), as kernel B2 sums its TD errors: a float
``index_add_`` on the card adds with atomics in a run-dependent order, and
its last-bit differences were enough to change which corner a CRMDP run
settles in from one run of the same seed to the next. Integer sums are
exact in any order, so a run is reproducible; the result differs from the
reference's float32 scatter by at most its rounding (``tests/
test_torch_crmdp.py`` holds the two to atol 1e-6).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .ppo import PPOAgent, PPOState


CORR_SCALE = 2.0 ** 32  # fixed-point units of the attribution's scatter-add


@dataclasses.dataclass
class CRMDPState(PPOState):
    corruption: torch.Tensor = None  # [S] f32 — per-state corruption estimate


def visit_norms(next_idx: torch.Tensor) -> torch.Tensor:
    """``[N]`` int64: each env's Σ_s n_is² over the ``[T, N]`` arrivals, from
    the column's sort: each element's equal-run length is its state's visit
    count, and the run lengths summed over the elements give Σ_s n_s² (the
    reference's ``searchsorted`` form)."""
    col = torch.sort(next_idx.T.contiguous(), dim=-1).values  # [N, T]
    left = torch.searchsorted(col, col, side="left")
    right = torch.searchsorted(col, col, side="right")
    return (right - left).sum(-1)


class PPOCRMDPAgent(PPOAgent):
    """PPO plus the corruption table; needs an env with a tabular state
    index."""

    def __init__(self, env, crmdp_lr: float = 0.05, **kw):
        super().__init__(env, **kw)
        if env.num_states is None:
            raise ValueError(f"{env.name}: CRMDP needs a tabular state index")
        self.name = "ppo-crmdp"
        self.crmdp_lr = crmdp_lr

    def init(self, device=None, seed: int = 0) -> CRMDPState:
        base = super().init(device, seed)
        dev = resolve_device(device)
        return CRMDPState(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                          corruption=torch.zeros(self.env.num_states, dtype=torch.float32,
                                                 device=dev))

    def update_corruption(self, corruption: torch.Tensor, next_idx: torch.Tensor,
                          observed: torch.Tensor, hidden: torch.Tensor,
                          axis_name=None) -> torch.Tensor:
        """One normalized-LMS step of the attribution (module doc) on the
        ``[T, N]`` arrival indices and observed and hidden rewards. Each
        env's error is divided by its Σ_s n_is², which keeps the step stable
        for any visit pattern."""
        if axis_name is not None:
            raise NotImplementedError(
                "the data-axis average of the corruption step is not ported yet "
                "(multi-device, ROADMAP A.14)")
        resid = (observed - hidden).sum(0)                       # [N]
        pred = corruption[next_idx.long()].sum(0)                # [N]
        err = pred - resid
        denom = visit_norms(next_idx).to(torch.float32)
        err_norm = err / torch.clamp(denom, min=1.0)              # [N]
        n = next_idx.shape[1]
        fx = torch.round(err_norm.to(torch.float64) * CORR_SCALE).to(torch.int64)
        sums = torch.zeros(corruption.shape, dtype=torch.int64, device=corruption.device)
        sums.index_add_(0, next_idx.reshape(-1).long(), fx.expand(next_idx.shape).reshape(-1))
        delta = (sums.to(torch.float64) / CORR_SCALE).to(torch.float32) / n
        return corruption - self.crmdp_lr * delta

    def relabel(self, corruption: torch.Tensor, rewards: torch.Tensor,
                next_idx: torch.Tensor) -> torch.Tensor:
        """r′ = r − ĉ(arrival state)."""
        return rewards - corruption[next_idx.long()]

    def attribute(self, corruption: torch.Tensor, traj):
        """One chunk's attribution step and relabel on a collected ``traj``
        (``next_idx``, ``observed``, ``hidden``, ``rewards``, all ``[T, N]``):
        returns ``(corruption, relabeled rewards)``."""
        corruption = self.update_corruption(corruption, traj["next_idx"], traj["observed"],
                                            traj["hidden"])
        return corruption, self.relabel(corruption, traj["rewards"], traj["next_idx"])
