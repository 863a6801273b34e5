import jax.numpy as jnp
import numpy as np

from stereo_reconstruction.ops import metrics


def _numpy_evaldisp(disp, gt, mask, badthresh, maxdisp, rounddisp):
    """Literal port of the reference evaldisp (utils.cpp:123-168) for
    cross-checking the jnp implementation."""
    n = bad = invalid = 0
    serr = 0.0
    H, W = gt.shape
    for y in range(H):
        for x in range(W):
            g = gt[y, x]
            if np.isinf(g):
                continue
            d = disp[y, x]
            valid = d != 0
            if valid:
                d = max(0.0, min(maxdisp, d))
            if valid and rounddisp:
                d = round(d)
            err = abs(d - g)
            if mask[y, x] != 255:
                continue
            n += 1
            if valid:
                serr += err
                if err > badthresh:
                    bad += 1
            else:
                invalid += 1
    return {
        "bad_percent": 100.0 * bad / n,
        "invalid_percent": 100.0 * invalid / n,
        "total_bad_percent": 100.0 * (bad + invalid) / n,
        "avg_err": serr / (n - invalid),
    }


def test_evaldisp_matches_reference_port(rng):
    H, W = 20, 30
    gt = rng.uniform(0, 60, (H, W)).astype(np.float32)
    gt[rng.random((H, W)) < 0.1] = np.inf           # unknown pixels
    disp = gt + rng.normal(0, 2, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.15] = 0             # invalid predictions
    mask = np.where(rng.random((H, W)) < 0.8, 255, 0).astype(np.uint8)

    want = _numpy_evaldisp(disp, gt, mask, badthresh=2.0, maxdisp=64.0, rounddisp=True)
    got = metrics.evaldisp(
        jnp.asarray(disp), jnp.asarray(gt), jnp.asarray(mask),
        bad_thresh=2.0, max_disp=64.0, round_disp=True,
    )
    for key, val in want.items():
        np.testing.assert_allclose(float(got[key]), val, rtol=1e-5, err_msg=key)


def test_evaldisp_all_valid():
    gt = jnp.ones((4, 4)) * 10.0
    disp = jnp.ones((4, 4)) * 10.5
    mask = jnp.full((4, 4), 255, dtype=jnp.uint8)
    m = metrics.evaldisp(disp, gt, mask, bad_thresh=2.0)
    assert float(m["bad_percent"]) == 0.0
    assert float(m["invalid_percent"]) == 0.0
    np.testing.assert_allclose(float(m["avg_err"]), 0.5, rtol=1e-6)


def test_bad_curve_monotone(rng):
    gt = jnp.asarray(rng.uniform(0, 50, (16, 16)).astype(np.float32))
    disp = gt + jnp.asarray(rng.normal(0, 3, (16, 16)).astype(np.float32))
    mask = jnp.full((16, 16), 255, dtype=jnp.uint8)
    curve = metrics.bad_curve(disp, gt, mask)
    assert float(curve["bad_0.5"]) >= float(curve["bad_1.0"]) >= float(curve["bad_2.0"])


def test_average_valid_disparity():
    disp = jnp.array([[1.0, jnp.inf], [3.0, 5.0]])
    np.testing.assert_allclose(float(metrics.average_valid_disparity(disp)), 3.0)
