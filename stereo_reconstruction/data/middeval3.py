"""MiddEval3 dataset index + loaders.

Equivalent of the reference ``DataLoader`` (``src/DataLoader/
data_loader.cpp:5-108``): enumerates and alphabetically sorts the
``trainingH``/``testH`` scenario directories, loads im0/im1, parses
``calib.txt``, reads GT disparity PFMs and nocc masks when present.

Differences from the reference (intentional):
  * paths are explicit, not cwd-relative (``directory.cpp:14-19``);
  * missing GT files yield ``None`` fields instead of aborting (the GT PFMs
    are large-blob assets that may be absent from a checkout);
  * scenario count is discovered, not hard-coded to 15;
  * images are RGB (the reference keeps OpenCV BGR; all reference math is
    channel-symmetric, so only mesh vertex colors care — handled in recon).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from stereo_reconstruction.data.records import StereoPair, pad_to
from stereo_reconstruction.io.calib import parse_calib
from stereo_reconstruction.io.image import read_image
from stereo_reconstruction.io.pfm import read_pfm

# the scenarios used for the reference's final evaluations (main.cpp:19)
EVAL_SCENARIOS = (0, 5, 8, 12, 13)  # Adirondack, MotorcycleE, Piano, Shelves, Teddy


class MiddEval3:
    def __init__(self, root: str):
        """``root`` is the MiddEval3 directory containing trainingH/testH."""
        self.root = root
        self.training_paths = self._scan("trainingH")
        self.test_paths = self._scan("testH")

    def _scan(self, split: str) -> List[str]:
        path = os.path.join(self.root, split)
        if not os.path.isdir(path):
            return []
        return sorted(
            os.path.join(path, d)
            for d in os.listdir(path)
            if os.path.isdir(os.path.join(path, d))
        )

    @property
    def num_training(self) -> int:
        return len(self.training_paths)

    @property
    def num_test(self) -> int:
        return len(self.test_paths)

    def training_names(self) -> List[str]:
        return [os.path.basename(p) for p in self.training_paths]

    def load_training(self, index: int) -> StereoPair:
        """Load a training scenario with GT disparities + masks if present
        (reference loadTrainingScenario, data_loader.cpp:64-90)."""
        return self._load(self.training_paths[index], with_gt=True)

    def load_test(self, index: int) -> StereoPair:
        """Load a test scenario: images + intrinsics only
        (reference loadTestScenario, data_loader.cpp:92-108)."""
        return self._load(self.test_paths[index], with_gt=False)

    def _load(self, path: str, with_gt: bool) -> StereoPair:
        calib = parse_calib(os.path.join(path, "calib.txt"))
        pair = StereoPair(
            image_left=read_image(os.path.join(path, "im0.png")),
            image_right=read_image(os.path.join(path, "im1.png")),
            intrinsics_left=calib.cam0,
            intrinsics_right=calib.cam1,
            name=os.path.basename(path),
            ndisp=calib.ndisp,
        )
        if with_gt:
            pair = _attach_gt(pair, path)
        return pair

    def load_batch(
        self,
        indices: Sequence[int],
        height: Optional[int] = None,
        width: Optional[int] = None,
        split: str = "training",
    ) -> List[StereoPair]:
        """Load several scenarios padded to a common static shape, ready to
        stack on the ``data`` mesh axis."""
        load = self.load_training if split == "training" else self.load_test
        pairs = [load(i) for i in indices]
        h = height or max(p.height for p in pairs)
        w = width or max(p.width for p in pairs)
        return [pad_to(p, h, w) for p in pairs]


def _attach_gt(pair: StereoPair, path: str) -> StereoPair:
    import dataclasses

    def _maybe_pfm(name):
        p = os.path.join(path, name)
        if os.path.exists(p):
            try:
                return read_pfm(p)
            except (ValueError, OSError):
                return None
        return None

    def _maybe_mask(name):
        p = os.path.join(path, name)
        return read_image(p, grayscale=True) if os.path.exists(p) else None

    return dataclasses.replace(
        pair,
        disp_left_gt=_maybe_pfm("disp0GT.pfm"),
        disp_right_gt=_maybe_pfm("disp1GT.pfm"),
        mask_left_nocc=_maybe_mask("mask0nocc.png"),
        mask_right_nocc=_maybe_mask("mask1nocc.png"),
    )


def downsample_pair(pair: StereoPair, factor: int = 2) -> StereoPair:
    """Area-downsample a pair (e.g. trainingH -> trainingQ-like quarter res).

    Disparity values are divided by ``factor`` (disparity scales with
    width); masks are strided.
    """
    import dataclasses

    def _img(a):
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float32)
        h, w = (a.shape[0] // factor) * factor, (a.shape[1] // factor) * factor
        a = a[:h, :w]
        a = a.reshape(h // factor, factor, w // factor, factor, -1).mean(axis=(1, 3))
        return np.squeeze(a).astype(np.float32)

    def _disp(a):
        if a is None:
            return None
        a = np.asarray(a)
        h, w = (a.shape[0] // factor) * factor, (a.shape[1] // factor) * factor
        return a[:h:factor, :w:factor] / factor

    def _mask(a):
        if a is None:
            return None
        a = np.asarray(a)
        h, w = (a.shape[0] // factor) * factor, (a.shape[1] // factor) * factor
        return a[:h:factor, :w:factor]

    def _K(K):
        K = np.asarray(K, dtype=np.float32).copy()
        K[:2] /= factor
        return K

    return dataclasses.replace(
        pair,
        image_left=_img(pair.image_left),
        image_right=_img(pair.image_right),
        intrinsics_left=_K(pair.intrinsics_left),
        intrinsics_right=_K(pair.intrinsics_right),
        disp_left_gt=_disp(pair.disp_left_gt),
        disp_right_gt=_disp(pair.disp_right_gt),
        mask_left_nocc=_mask(pair.mask_left_nocc),
        mask_right_nocc=_mask(pair.mask_right_nocc),
        ndisp=max(1, pair.ndisp // factor),
    )
