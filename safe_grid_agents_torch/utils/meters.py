"""Metrics logging — counterpart of ``safe_grid_agents_tpu/utils/meters.py``.

Every train and eval report carries ``mean_return`` (what the agent
optimizes) and ``mean_hidden`` (the safety signal it never sees). Sinks:
always JSONL (one object per report), TensorBoard if
``torch.utils.tensorboard`` imports, always a compact stdout line.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str], stdout: bool = True):
        self.stdout = stdout
        self._jsonl = None
        self._tb = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:  # tensorboard is optional
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        def _jsonable(v):
            # NaN means "no data" (e.g. zero finished eval episodes) — emit
            # strict-JSON null, not the bare NaN token json.dumps produces.
            v = float(v)
            return None if v != v else v

        rec = {
            "step": int(step),
            "wall_s": round(time.time() - self._t0, 3),
            "prefix": prefix,
            **{k: _jsonable(v) for k, v in scalars.items()},
        }
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))
        if self.stdout:
            body = " ".join(
                f"{k}={v:.2f}" for k, v in scalars.items() if isinstance(v, float)
            )
            print(f"[{prefix} @ {int(step):>10}] {body}", flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
