#!/usr/bin/env python3
"""BASELINE config 4: dense matching at full (trainingF) resolution.

Proves the HBM-pressure case (SURVEY hard-part #4): a trainingF-sized
pair — (1984, 2872), synthesized by 2x nearest upsampling of the real
trainingH Adirondack pair (trainingF itself isn't shipped in the
reference data) — matched at D=400 with the D-chunked cost-volume
accumulation, tile-sharded over an 8-device virtual CPU mesh: row tiles
+ ppermute halo exchange, per-shard cost-volume block ~D x (H/8 + halo) x
W; scored for agreement against the unsharded full-volume run and against
the exact reference-semantics oracle.

Writes ``baselines/config4_fullres.json``. Reference anchor: the
BlockSearch hot loop (src/WindowSearch/BlockSearch.cpp:88-179) at the
resolution the reference never reaches on one GPU without tiling.

Usage:
  python tools/config4_fullres.py [--max-disparity D]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from stereo_reconstruction.utils import compile_cache  # noqa: E402

compile_cache.enable()

DATA = "/root/reference/data/MiddEval3/trainingH/Adirondack"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "..", "baselines", "config4_fullres.json")



def _git_hash():
    import subprocess
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True).stdout.strip()
    except OSError:
        return "unknown"

def load_fullres():
    from stereo_reconstruction.io.image import read_image

    L = read_image(os.path.join(DATA, "im0.png")).astype(np.float32)
    R = read_image(os.path.join(DATA, "im1.png")).astype(np.float32)
    # trainingF-sized canvas: 2x nearest upsample of the real half-res pair
    L = np.repeat(np.repeat(L, 2, axis=0), 2, axis=1)
    R = np.repeat(np.repeat(R, 2, axis=0), 2, axis=1)
    return L, R


def merge_write(update):
    report = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            report = json.load(f)
    report.update(update)
    with open(OUT, "w") as f:
        report["git"] = _git_hash()
        json.dump(report, f, indent=2)
    print(json.dumps(update, indent=2))


def run_cpu(n_tiles: int = 8, D: int = 400):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_tiles}"
        ).strip()

    import jax
    import jax.numpy as jnp

    from stereo_reconstruction import oracle
    from stereo_reconstruction.config import MatcherConfig
    from stereo_reconstruction.ops.block_search import block_search_right
    from stereo_reconstruction.parallel import (
        make_mesh, sharded_block_search_right,
    )

    L, R = load_fullres()
    h, w = R.shape[:2]
    hcrop = (h // n_tiles) * n_tiles          # tile-divisible height
    L, R = L[:hcrop], R[:hcrop]
    h = hcrop
    cfg = MatcherConfig(block_size=17, min_disparity=0, max_disparity=D,
                        smooth_factor=0.9, row_smooth_iters=2)

    mesh = make_mesh(data=1, tile=n_tiles, devices=jax.devices()[:n_tiles])
    Lb = jnp.asarray(L)[None]
    Rb = jnp.asarray(R)[None]

    t0 = time.time()
    disp_sh = np.asarray(
        sharded_block_search_right(Lb, Rb, mesh, cfg, warmup=64)
    )[0]
    t_sharded = time.time() - t0

    t0 = time.time()
    disp_un = np.asarray(
        jax.jit(lambda a, b: block_search_right(a, b, cfg))(
            jnp.asarray(L), jnp.asarray(R))
    )
    t_unsharded = time.time() - t0

    agree = float((disp_sh == disp_un).mean())

    # exact reference-semantics oracle on the full image (NumPy, slow)
    t0 = time.time()
    ref = oracle.block_search_right_fast(L, R, 17, 0, D, 0.9)
    t_oracle = time.time() - t0
    oracle_agree = float((disp_un == ref).mean())
    oracle_agree_sh = float((disp_sh == ref).mean())

    halo = 64 + 2 * 8 + 2 * 8            # warmup + window halos
    shard_rows = h // n_tiles + halo
    merge_write({"cpu_virtual_mesh": {
        "image": f"{h}x{w}", "D": D, "n_tiles": n_tiles,
        "per_shard_cost_block_gib": round(D * shard_rows * w * 4 / 2**30, 2),
        "full_volume_gib": round(D * h * w * 4 / 2**30, 2),
        "t_sharded_s": round(t_sharded, 1),
        "t_unsharded_s": round(t_unsharded, 1),
        "t_oracle_s": round(t_oracle, 1),
        "sharded_vs_unsharded_agreement": round(agree, 6),
        "unsharded_vs_oracle_agreement": round(oracle_agree, 6),
        "sharded_vs_oracle_agreement": round(oracle_agree_sh, 6),
    }})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-disparity", type=int, default=400)
    args = ap.parse_args()
    run_cpu(D=args.max_disparity)


if __name__ == "__main__":
    main()
