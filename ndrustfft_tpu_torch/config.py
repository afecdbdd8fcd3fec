"""Runtime configuration for ndrustfft_tpu_torch.

Only what the port uses: ``debug_plan_log`` prints one stderr line per call
naming the route ``api._route`` chose. Nothing here switches the kernels off
on a CUDA tensor.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class _Config:
    debug_plan_log: bool = os.environ.get(
        "NDRUSTFFT_TORCH_DEBUG_PLAN", "0") in ("1", "true")


config = _Config()
