"""Pure-NumPy PFM (Portable Float Map) codec.

Replaces the reference's native Middlebury-SDK ``imageLib`` dependency
(``ReadImageVerb``/``CFloatImage``, used at reference
``src/DataLoader/data_loader.cpp:112-114``) with a dependency-free reader
and writer matching the format semantics: ``Pf`` (grayscale) / ``PF``
(3-channel) header, width/height line, scale line whose sign encodes
endianness, rows stored bottom-up.
"""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file into a float32 array of shape (H, W) or (H, W, 3).

    Row 0 of the returned array is the *top* image row (PFM stores rows
    bottom-up, matching the Middlebury SDK convention the reference relies
    on). Dispatches to the native C++ codec (native/stereo_io.cpp) when
    built, like io/image.py.
    """
    try:
        from stereo_reconstruction.io import native

        if native.available():
            return native.read_pfm(path)
    except Exception:
        pass  # fall back to the pure-NumPy reader
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: bad header {header!r}")

        dims = _read_token_line(f)
        width, height = (int(v) for v in dims.split())

        scale = float(_read_token_line(f))
        little_endian = scale < 0
        dtype = "<f4" if little_endian else ">f4"

        count = width * height * channels
        data = np.frombuffer(f.read(count * 4), dtype=dtype, count=count)

    shape = (height, width, channels) if channels == 3 else (height, width)
    img = data.reshape(shape)
    # bottom-up -> top-down
    img = np.flipud(img)
    return np.ascontiguousarray(img, dtype=np.float32)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array of shape (H, W) or (H, W, 3) as PFM."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        header = b"Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    if scale <= 0:
        raise ValueError("scale must be positive (sign encodes endianness)")

    height, width = image.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{width} {height}\n".encode())
        # negative scale = little-endian payload
        f.write(f"{-scale:.6f}\n".encode())
        f.write(np.flipud(image).astype("<f4").tobytes())


def _read_token_line(f) -> str:
    """Read one non-comment line (PFM allows '#' comment lines)."""
    line = f.readline().decode("latin-1").strip()
    while line.startswith("#"):
        line = f.readline().decode("latin-1").strip()
    return line
