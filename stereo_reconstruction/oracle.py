"""Numerically faithful NumPy oracle of the reference dense matcher.

The reference publishes no benchmark numbers (see BASELINE.md); the
operative quality baseline is *the reference pipeline's own output*. This
module reproduces the reference's ``BlockSearch``/``LinearSearch``
(``src/WindowSearch/BlockSearch.cpp``, ``LinearSearch.cpp``) semantics in
NumPy, loop-for-loop, so tests and benchmarks can score the device kernels
against the exact reference behavior without building the C++ tree.

Two tiers:
  * ``*_loop``   — literal scalar-loop ports; exact, O(H*W*D*B^2); for
                   small crops in tests.
  * ``*_fast``   — vectorized integral-image equivalents; integer-exact
                   cost computation, same argmin/smoothing recurrences run
                   sequentially; for full-image baseline generation.

Reference quirks preserved (documented; see also SURVEY.md):
  * Right-variant smoothing compares the neighbor's disparity against
    ``pointX - correspondX`` = **-d** (BlockSearch.cpp:160-165) while the
    stored disparity is +d, so the discount effectively fires only for
    d == 0 next to disparity-0 neighbors. The Left variant compares +d
    (correct sign).
  * windows are half-open: ``cv::Rect(x-left, y-up, left+right, up+down)``
    spans [x-left, x+right) x [y-up, y+down) (BlockSearch.cpp:116-123).
  * pixels with no valid candidate keep ``minimumCorrespondX = 0``:
    Right stores disparity ``-x``, Left stores ``+x``.
  * the variable-window "texture" measure uses a saturating uint8
    subtraction: ||max(0, win - mean)||_2 (BlockSearch.cpp:125-142).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# literal loop ports (test oracle)
# ---------------------------------------------------------------------------

def block_search_right_loop(
    left: np.ndarray,         # (H1, W1, 3) uint8 rectified left image
    right: np.ndarray,        # (H2, W2, 3) uint8 rectified right image
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    smooth_factor: float = 0.9,
    var_block: bool = False,
    texture_threshold: float = 19.0,
) -> np.ndarray:
    """Literal port of BlockSearch::computeDisparityMapRight
    (BlockSearch.cpp:88-179)."""
    left = np.asarray(left)
    right = np.asarray(right)
    h1, w1 = left.shape[:2]
    h2, w2 = right.shape[:2]
    height = min(h1, h2)
    hbs = (block_size - 1) // 2

    L = left.astype(np.int64)
    R = right.astype(np.int64)
    disp = np.zeros((h2, w2), dtype=np.float64)

    for y in range(height):
        for x in range(w2):
            if (right[y, x] == 0).all():
                continue

            bs = block_size
            l = min(x, (bs - 1) // 2)
            r = min(w2 - x - 1, (bs - 1) // 2)
            u = min(y, (bs - 1) // 2)
            d_ = min(h2 - y - 1, (bs - 1) // 2)

            if var_block:
                while _texture(right, x, y, l, r, u, d_) < texture_threshold:
                    bs += 4
                    l = min(x, (bs - 1) // 2)
                    r = min(w2 - x - 1, (bs - 1) // 2)
                    u = min(y, (bs - 1) // 2)
                    d_ = min(h2 - y - 1, (bs - 1) // 2)
                    if l + r >= w2 - 1 and u + d_ >= h2 - 1:
                        break

            win_r = R[y - u : y + d_, x - l : x + r]
            area = (l + r) * (u + d_)
            best_cx = 0
            best = np.inf

            for cx in range(x + min_disparity, x + max_disparity):
                if cx + r >= w1:
                    break
                win_l = L[y - u : y + d_, cx - l : cx + r]
                ssd = np.sum((win_l - win_r) ** 2)
                dist = np.sqrt(float(ssd)) / area if area > 0 else np.inf

                # NOTE reference sign quirk: compares against x - cx == -d
                if y >= 1 and disp[y - 1, x] == float(x - cx):
                    dist *= smooth_factor
                if x >= 1 and disp[y, x - 1] == float(x - cx):
                    dist *= smooth_factor

                if dist < best:
                    best_cx = cx
                    best = dist

            disp[y, x] = float(best_cx - x)
    return disp


def block_search_left_loop(
    left: np.ndarray,
    right: np.ndarray,
    block_size: int = 17,
    max_disparity: int = 200,
    smooth_factor: float = 0.9,
) -> np.ndarray:
    """Literal port of BlockSearch::computeDisparityMapLeft
    (BlockSearch.cpp:24-86)."""
    left = np.asarray(left)
    right = np.asarray(right)
    h1, w1 = left.shape[:2]
    h2, w2 = right.shape[:2]
    height = min(h1, h2)
    hbs = (block_size - 1) // 2

    L = left.astype(np.int64)
    R = right.astype(np.int64)
    disp = np.zeros((h1, w1), dtype=np.float64)

    for y in range(hbs, height - hbs):
        for x in range(hbs, w1 - hbs):
            if (left[y, x] == 0).all():
                continue

            win_l = L[y - hbs : y + hbs + 1, x - hbs : x + hbs + 1]
            best_cx = 0
            best = np.inf
            for cx in range(x - max_disparity, x):
                if cx < hbs or cx >= w2 - hbs:
                    continue
                win_r = R[y - hbs : y + hbs + 1, cx - hbs : cx + hbs + 1]
                dist = np.sqrt(float(np.sum((win_l - win_r) ** 2)))

                # Left variant: correct sign (x - cx == +d)
                if y >= 1 and disp[y - 1, x] == float(x - cx):
                    dist *= smooth_factor
                if x >= 1 and disp[y, x - 1] == float(x - cx):
                    dist *= smooth_factor

                if dist < best:
                    best_cx = cx
                    best = dist
            disp[y, x] = float(x - best_cx)
    return disp


def linear_search_loop(
    left: np.ndarray,
    right: np.ndarray,
    smooth_factor: float = 0.9,
    search_range: int = 200,
) -> np.ndarray:
    """Port of LinearSearch::computeDisparityMap (LinearSearch.cpp:10-59).

    Deviation: the reference indexes ``leftImage.at(i, k)`` with k up to
    j+199 without a bounds check (out-of-row reads in C++); here candidates
    with k >= W1 are skipped.
    """
    left = np.asarray(left)
    right = np.asarray(right)
    h2, w2 = right.shape[:2]
    w1 = left.shape[1]
    L = left.astype(np.float64)
    R = right.astype(np.float64)
    disp = np.zeros((h2, w2), dtype=np.float64)

    for i in range(h2):
        for j in range(w2):
            if (left[i, j] == 0).all():   # reference tests the LEFT image
                disp[i, j] = 0
                continue
            best_col = 0
            best = np.inf
            for k in range(j, j + search_range):
                if k >= w1:
                    break
                dist = np.sqrt(np.sum((R[i, j] - L[i, k]) ** 2))
                if i >= 1 and disp[i - 1, j] == float(j - k):
                    dist *= smooth_factor
                if j >= 1 and disp[i, j - 1] == float(j - k):
                    dist *= smooth_factor
                if dist < best:
                    best_col = k
                    best = dist
            disp[i, j] = float(best_col - j)
    return disp


def _texture(right: np.ndarray, x: int, y: int, l: int, r: int, u: int, d: int) -> float:
    """Variable-window texture measure with cv::subtract's uint8 saturation
    (BlockSearch.cpp:125-128): ||max(0, win - round(mean))||_2."""
    win = right[y - u : y + d, x - l : x + r].astype(np.float64)
    if win.size == 0:
        return 0.0
    mean = win.reshape(-1, win.shape[-1]).mean(axis=0)
    # cv::subtract(8U - scalar) rounds the scalar then saturates at 0
    diff = np.clip(np.round(win - mean), 0, 255)
    return float(np.sqrt(np.sum(diff**2)))


# ---------------------------------------------------------------------------
# vectorized equivalents (baseline generation on full images)
# ---------------------------------------------------------------------------

def cost_volume_right(
    left: np.ndarray,
    right: np.ndarray,
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
) -> np.ndarray:
    """(H2, W2, D) cost volume with the exact Right-variant window cost:
    sqrt(clipped-window SSD) / area; +inf where the candidate is invalid.

    Integer-exact: window sums are int64 integral-image sums of squared
    uint8 diffs, so this matches the loop port bit-for-bit (before sqrt).
    """
    left = np.asarray(left)
    right = np.asarray(right)
    h1, w1 = left.shape[:2]
    h2, w2 = right.shape[:2]
    height = min(h1, h2)
    hbs = (block_size - 1) // 2
    D = max_disparity - min_disparity

    ys = np.arange(h2)
    xs = np.arange(w2)
    up = np.minimum(ys, hbs)[:, None]            # (H2, 1)
    down = np.minimum(h2 - ys - 1, hbs)[:, None]
    lft = np.minimum(xs, hbs)[None, :]           # (1, W2)
    rgt = np.minimum(w2 - xs - 1, hbs)[None, :]
    area = ((lft + rgt) * (up + down)).astype(np.float64)  # (H2, W2)

    cost = np.full((h2, w2, D), np.inf, dtype=np.float64)

    y0 = (ys[:, None] - up)                       # window top (inclusive)
    y1 = (ys[:, None] + down)                     # window bottom (exclusive)
    x0 = (xs[None, :] - lft)
    x1 = (xs[None, :] + rgt)

    for di, d in enumerate(range(min_disparity, max_disparity)):
        # diffsq_d[y, x] defined where x + d < w1
        wv = min(w1 - d, w2)
        if wv <= 0:
            continue
        diff = left[:height, d : d + wv].astype(np.int64) - right[:height, :wv].astype(np.int64)
        dsq = np.sum(diff * diff, axis=-1)        # (height, wv)
        # integral image with zero row/col prepended
        S = np.zeros((height + 1, wv + 1), dtype=np.int64)
        np.cumsum(np.cumsum(dsq, axis=0), axis=1, out=S[1:, 1:])

        # valid candidates: x + d + rgt < w1 and y < height and window rows
        # within [0, height)
        yy0 = np.clip(y0[:height], 0, height)
        yy1 = np.clip(y1[:height], 0, height)
        xx1 = x1[0]
        valid = (xs[None, :] + d + rgt[0][None, :] < w1) & (xx1[None, :] <= wv)
        # guard indices
        cx0 = np.minimum(x0[0], wv)
        cx1 = np.minimum(xx1, wv)
        win = (
            S[yy1, cx1[None, :]]
            - S[yy0, cx1[None, :]]
            - S[yy1, cx0[None, :]]
            + S[yy0, cx0[None, :]]
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.sqrt(win.astype(np.float64)) / area[:height]
        c = np.where(valid & (area[:height] > 0), c, np.inf)
        cost[:height, :, di] = c
    return cost


def smooth_argmin_right(
    cost: np.ndarray,          # (H, W, D) from cost_volume_right
    right: np.ndarray,         # (H, W, 3) uint8 (black-pixel skip)
    min_disparity: int = 0,
    smooth_factor: float = 0.9,
) -> np.ndarray:
    """Sequential smoothing + argmin recurrence of the Right variant,
    including the sign quirk (discount where neighbor disp == -d)."""
    h, w, D = cost.shape
    disp = np.zeros((h, w), dtype=np.float64)
    black = (np.asarray(right)[:h, :w] == 0).all(axis=-1)
    dvals = np.arange(min_disparity, min_disparity + D, dtype=np.float64)

    for y in range(h):
        for x in range(w):
            if black[y, x]:
                continue
            c = cost[y, x]
            mods = np.ones(D)
            if y >= 1:
                mods[dvals == -disp[y - 1, x]] = smooth_factor
            if x >= 1:
                m2 = dvals == -disp[y, x - 1]
                mods[m2] *= smooth_factor
            cc = c * mods
            if not np.isfinite(cc).any():
                disp[y, x] = -float(x)
                continue
            di = int(np.argmin(cc))
            disp[y, x] = dvals[di] if np.isfinite(cc[di]) else -float(x)
    return disp


def block_search_right_fast(
    left: np.ndarray,
    right: np.ndarray,
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    smooth_factor: float = 0.9,
) -> np.ndarray:
    """Vectorized-cost + sequential-smoothing Right variant (fixed window)."""
    cost = cost_volume_right(left, right, block_size, min_disparity, max_disparity)
    return smooth_argmin_right(cost, right, min_disparity, smooth_factor)


def remove_disparity_outliers(
    disp: np.ndarray, kernel: int = 500, thr_front: float = 1.5, thr_back: float = 0.8
) -> np.ndarray:
    """Port of removeDisparityOutliers (reconstruction.cpp:5-18): box-blur
    (reflect-101 borders, like cv::blur) then clamp values outside
    [thr_back * blur, thr_front * blur] to the blurred value."""
    disp = np.asarray(disp, dtype=np.float32)
    blurred = box_blur(disp, kernel)
    out = disp.copy()
    mask = (disp > thr_front * blurred) | (disp < thr_back * blurred)
    out[mask] = blurred[mask]
    return out


def box_blur(img: np.ndarray, kernel: int) -> np.ndarray:
    """cv::blur equivalent: normalized box filter, BORDER_REFLECT_101,
    anchor at kernel center."""
    img = np.asarray(img, dtype=np.float64)
    h, w = img.shape
    ka = (kernel - 1) // 2       # anchor offset (left/top)
    kb = kernel - 1 - ka
    # reflect-101 padding; np.pad 'reflect' == BORDER_REFLECT_101, but the
    # pad amount may exceed dim-1 for huge kernels -> pad iteratively
    padded = _reflect101_pad(img, ka, kb)
    S = np.zeros((padded.shape[0] + 1, padded.shape[1] + 1))
    np.cumsum(np.cumsum(padded, axis=0), axis=1, out=S[1:, 1:])
    out = (
        S[kernel : kernel + h, kernel : kernel + w]
        - S[0:h, kernel : kernel + w]
        - S[kernel : kernel + h, 0:w]
        + S[0:h, 0:w]
    )
    return (out / (kernel * kernel)).astype(np.float32)


def _reflect101_pad(img: np.ndarray, before: int, after: int) -> np.ndarray:
    out = img
    for axis in (0, 1):
        n = out.shape[axis]
        b, a = before, after
        chunks = []
        # build index map supporting pads larger than n-1 (period 2n-2)
        idx = np.arange(-b, n + a)
        period = max(2 * n - 2, 1)
        idx = np.mod(idx, period)
        idx = np.where(idx >= n, period - idx, idx)
        out = np.take(out, idx, axis=axis)
    return out


def convert_disparity_to_depth(
    disp: np.ndarray, focal_length: float, baseline: float = 1.0
) -> np.ndarray:
    """Port of convertDisparityToDepth (reconstruction.cpp:30-43):
    depth = f*b/d; zero disparity -> -inf sentinel (reference MINF)."""
    disp = np.asarray(disp, dtype=np.float32)
    with np.errstate(divide="ignore"):
        depth = focal_length * baseline / disp
    return np.where(disp == 0, -np.inf, depth).astype(np.float32)
