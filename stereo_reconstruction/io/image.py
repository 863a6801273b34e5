"""Host-side image I/O.

The reference loads images with ``cv::imread`` (BGR byte images,
``src/DataLoader/data_loader.cpp:71-72``) and round-trips disparity maps
through uint8 grayscale PNGs (``src/main.cpp:42,50`` /
``readGrayscaleImageAsDisparityMap``, ``data_loader.cpp:191-203``). Here
images are RGB float arrays on the host; the uint8 PNG round-trip is kept
available as an explicit compatibility mode (it quantizes disparity).
"""

from __future__ import annotations

import numpy as np


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image as uint8, shape (H, W, 3) RGB or (H, W) grayscale.

    Uses the native C++ decoder (native/stereo_io.cpp) when built — the
    framework's equivalent of the reference's native data layer — and
    falls back to PIL. Outputs are validated byte-identical in tests.
    """
    if path.lower().endswith(".png"):
        from stereo_reconstruction.io import native

        if native.available():
            try:
                return native.read_png(path, channels=1 if grayscale else 3)
            except (IOError, OSError):
                pass  # fall back for exotic encodings (16-bit, interlaced)
    # PIL only here and in write_image: the pipeline itself never needs it
    from PIL import Image

    with Image.open(path) as im:
        if grayscale:
            im = im.convert("L")
            return np.asarray(im, dtype=np.uint8)
        im = im.convert("RGB")
        return np.asarray(im, dtype=np.uint8)


def write_image(path: str, array: np.ndarray) -> None:
    """Write a uint8 array ((H,W) or (H,W,3)) as PNG. Float inputs are
    clipped to [0, 255] and truncated like the reference's cv::imwrite of a
    CV_64F disparity map (saturate-cast)."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    from PIL import Image

    Image.fromarray(arr).save(path)


def disparity_png_roundtrip(disparity: np.ndarray) -> np.ndarray:
    """Quantize disparity to uint8 and back to float32.

    Mirrors the reference pipeline's write-then-read of the disparity map
    (``main.cpp:42,50``): values are rounded, clipped to [0, 255], and
    returned as float. The framework stages float PFMs by default; this is
    the explicit compat path.
    """
    q = np.clip(np.round(disparity), 0, 255).astype(np.uint8)
    return q.astype(np.float32)
