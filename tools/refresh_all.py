#!/usr/bin/env python3
"""Regenerate every recorded baseline artifact and pin it to HEAD.

Every baselines/*.json (and SCALING.json / MULTIHOST.json) records the
git revision it was generated at; the staleness check in tests/conftest.py
warns when code under stereo_reconstruction/, native/ or the recorder
changed since. This driver reruns each recorder (all on the CPU; most
need the MiddEval3 data) and verifies the stamps afterward:

    python tools/refresh_all.py            # everything
    python tools/refresh_all.py --only scaling,multihost

then commit the regenerated artifacts (a baselines-only commit keeps the
stamps valid: the staleness check ignores commits that touch no
generating code).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU_ENV = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")

# (name, argv, env, timeout_s, artifacts)
RECORDERS = [
    ("scaling", ["tools/scaling_bench.py"], CPU_ENV, 2400,
     ["SCALING.json"]),
    ("multihost", ["tools/multihost_bench.py"], CPU_ENV, 3000,
     ["MULTIHOST.json"]),
    ("perceptual_parity", ["tools/perceptual_parity.py"], CPU_ENV, 3000,
     ["baselines/perceptual_parity.json"]),
    ("uncalibrated", ["tools/uncalibrated_eval.py"], CPU_ENV, 2400,
     ["baselines/uncalibrated_eval.json"]),
    ("full_eval", ["tools/full_eval.py"], CPU_ENV, 5400,
     ["baselines/full_eval.json"]),
    ("config4_mesh", ["tools/config4_fullres.py"], CPU_ENV, 3000,
     ["baselines/config4_fullres.json"]),
]


def head_hash() -> str:
    return subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
        capture_output=True, text=True).stdout.strip()


def artifact_hash(path: str) -> str | None:
    try:
        with open(os.path.join(REPO, path)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return (data.get("_meta") or {}).get("git") or data.get("git")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma list of recorder names")
    ap.add_argument("--skip", default="", help="comma list to skip")
    ap.add_argument("--check", action="store_true",
                    help="no reruns; just verify stamps == HEAD")
    args = ap.parse_args()

    only = {x for x in args.only.split(",") if x}
    skip = {x for x in args.skip.split(",") if x}
    head = head_hash()
    failures = []

    if not args.check:
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=REPO, capture_output=True, text=True).stdout.strip()
        if dirty:
            print("WARNING: working tree dirty — stamps will record HEAD "
                  "but the artifacts reflect uncommitted code:\n" + dirty)
        for name, argv, env, tmo, artifacts in RECORDERS:
            if (only and name not in only) or name in skip:
                continue
            print(f"=== {name} (timeout {tmo}s)", flush=True)
            t0 = time.time()
            r = subprocess.run([sys.executable] + argv, cwd=REPO, env=env,
                               timeout=tmo)
            print(f"=== {name}: rc={r.returncode} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if r.returncode != 0:
                failures.append(name)

    print(f"\nHEAD = {head}")
    stale = []
    for _, _, _, _, artifacts in RECORDERS:
        for a in artifacts:
            h = artifact_hash(a)
            status = "OK" if h == head else f"STALE ({h})"
            if h != head:
                stale.append(a)
            print(f"  {a:45s} {status}")
    if failures:
        print(f"FAILED recorders: {failures}")
        sys.exit(1)
    if stale and not args.check:
        print(f"stale stamps remain: {sorted(set(stale))}")
        sys.exit(2)


if __name__ == "__main__":
    main()
