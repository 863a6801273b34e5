"""Per-scenario data record.

Equivalent of the reference's ``Data`` value object
(``src/DataLoader/data.h:10-60``): an immutable pytree of arrays (images,
intrinsics, optional GT disparities + nocc masks) plus static metadata.
Being a pytree, a batch of pairs can be stacked/padded and sharded over the
``data`` mesh axis directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StereoPair:
    image_left: jax.Array | np.ndarray      # (H, W, 3) uint8 or float32 RGB
    image_right: jax.Array | np.ndarray     # (H, W, 3)
    intrinsics_left: jax.Array | np.ndarray   # (3, 3) float32
    intrinsics_right: jax.Array | np.ndarray  # (3, 3) float32
    disp_left_gt: Optional[jax.Array | np.ndarray] = None   # (H, W) float32, inf=unknown
    disp_right_gt: Optional[jax.Array | np.ndarray] = None
    mask_left_nocc: Optional[jax.Array | np.ndarray] = None   # (H, W) uint8, 255=eval
    mask_right_nocc: Optional[jax.Array | np.ndarray] = None
    name: str = dataclasses.field(default="", metadata=dict(static=True))
    ndisp: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def height(self) -> int:
        return int(self.image_left.shape[0])

    @property
    def width(self) -> int:
        return int(self.image_left.shape[1])

    def with_images(self, left, right) -> "StereoPair":
        return dataclasses.replace(self, image_left=left, image_right=right)


def pad_to(pair: StereoPair, height: int, width: int) -> StereoPair:
    """Zero-pad images/disparities/masks to a static (height, width) budget.

    Zero padding keeps the reference's black-pixel-skip semantics: padded
    pixels are black, so the matcher assigns them disparity 0 and ``evaldisp``
    masks them out (mask padded with 0 != 255).
    """

    def _pad(arr, fill=0):
        if arr is None:
            return None
        arr = np.asarray(arr)
        ph, pw = height - arr.shape[0], width - arr.shape[1]
        if ph < 0 or pw < 0:
            raise ValueError(f"array {arr.shape} exceeds pad budget {(height, width)}")
        widths = [(0, ph), (0, pw)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, widths, constant_values=fill)

    return dataclasses.replace(
        pair,
        image_left=_pad(pair.image_left),
        image_right=_pad(pair.image_right),
        disp_left_gt=_pad(pair.disp_left_gt, fill=np.inf),
        disp_right_gt=_pad(pair.disp_right_gt, fill=np.inf),
        mask_left_nocc=_pad(pair.mask_left_nocc),
        mask_right_nocc=_pad(pair.mask_right_nocc),
    )
