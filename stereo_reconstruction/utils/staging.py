"""Staged artifacts + resume (SURVEY.md §5 checkpoint/resume).

The reference pipeline is file-staged: the disparity map is written to a
PNG and re-read (main.cpp:42,50), rectified images and HitNet results are
persisted under ``results/`` and consumed by later runs. This module makes
that staging explicit and lossless: every stage writes a typed artifact
(float PFM for disparities, JSON for poses/metrics), and a pipeline run
can resume from whatever stages already exist.

The reference's uint8 PNG round-trip quantizes disparity; here the float
PFM is canonical and the PNG path is a compat mode (io/image.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from stereo_reconstruction.io.pfm import read_pfm, write_pfm


@dataclasses.dataclass
class StageStore:
    """Artifact directory for one scenario."""

    root: str
    scenario: str

    def _path(self, stage: str, ext: str) -> str:
        return os.path.join(self.root, self.scenario, f"{stage}.{ext}")

    def has(self, stage: str, kind: str = "pfm") -> bool:
        return os.path.exists(self._path(stage, kind))

    def save_array(self, stage: str, array: np.ndarray) -> str:
        path = self._path(stage, "pfm")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_pfm(path, np.asarray(array, np.float32))
        return path

    def load_array(self, stage: str) -> np.ndarray:
        return read_pfm(self._path(stage, "pfm"))

    def save_json(self, stage: str, payload: Dict[str, Any]) -> str:
        path = self._path(stage, "json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=_np_default)
        return path

    def load_json(self, stage: str) -> Dict[str, Any]:
        with open(self._path(stage, "json")) as f:
            return json.load(f)

    def resume_or_compute(self, stage: str, compute, kind: str = "pfm"):
        """Return the staged artifact if present, else compute + stage it."""
        if kind == "pfm" and self.has(stage, "pfm"):
            return self.load_array(stage)
        if kind == "json" and self.has(stage, "json"):
            return self.load_json(stage)
        value = compute()
        if kind == "pfm":
            self.save_array(stage, value)
        else:
            self.save_json(stage, value)
        return value


def _np_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)
