"""Sharding runtime on ``torch.distributed`` (counterpart of
``safe_grid_agents_tpu/parallel``): process grids (``mesh``), the
collectives the trainers call with ``group=`` and the model axis's
operators (``collectives``), joining a launcher's group (``multihost``),
local ranks (``launch``), the DP and dp×tp trainer wrappers
(``dp.DPTrainer``, ``tp.TPTrainer``; import them from their modules, which
import the trainers) and the pipeline, expert and ring-attention demos
(``pp``, ``ep``, ``sp``)."""
from .collectives import all_gather_lanes, pmean_flat, psum, psum_flat
from .mesh import DATA_AXIS, MODEL_AXIS, AxisGroup, DataGroup, make_1d_mesh, make_mesh
from .multihost import ensure_initialized, is_primary

__all__ = ["DATA_AXIS", "MODEL_AXIS", "AxisGroup", "DataGroup", "all_gather_lanes",
           "ensure_initialized", "is_primary", "make_1d_mesh", "make_mesh", "pmean_flat",
           "psum", "psum_flat"]
