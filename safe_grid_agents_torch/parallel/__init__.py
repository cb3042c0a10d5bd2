"""Data-parallel runtime on ``torch.distributed`` (counterpart of
``safe_grid_agents_tpu/parallel``): data groups (``mesh``), the
collectives the trainers call with ``group=`` (``collectives``), joining a
launcher's group (``multihost``), local ranks (``launch``) and the DP
trainer wrapper (``dp.DPTrainer``; import it from ``parallel.dp``, which
imports the trainers). The reference's ``--tp`` runtime and its ``pp``,
``ep`` and ``sp`` demos are not ported (ROADMAP A.14b)."""
from .collectives import all_gather_lanes, pmean_flat, psum, psum_flat
from .mesh import DATA_AXIS, DataGroup, make_mesh
from .multihost import ensure_initialized, is_primary

__all__ = ["DATA_AXIS", "DataGroup", "all_gather_lanes", "ensure_initialized",
           "is_primary", "make_mesh", "pmean_flat", "psum", "psum_flat"]
