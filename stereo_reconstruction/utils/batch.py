"""Batch runner with per-pair failure masking (SURVEY.md §5 failure
detection).

The reference aborts the whole process on any failure (``throw
std::runtime_error`` on scenario bounds, <8 matches, cheirality failure,
<60 BA points). Running batches of pairs, a single bad pair must not sink
the batch: each pair's result carries a validity flag and an error string;
failed pairs are masked out of aggregate metrics.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from stereo_reconstruction.utils.profiling import append_jsonl


@dataclasses.dataclass
class PairOutcome:
    name: str
    ok: bool
    result: Any = None
    error: str = ""


def run_batch(
    pairs: Sequence,
    fn: Callable,
    metrics_path: Optional[str] = None,
) -> List[PairOutcome]:
    """Apply ``fn(pair)`` to each pair, masking failures.

    Device-level errors (bad pose, too few matches) surface as validity
    flags inside results; host-level exceptions are caught per pair.
    """
    outcomes: List[PairOutcome] = []
    for pair in pairs:
        name = getattr(pair, "name", str(len(outcomes)))
        try:
            result = fn(pair)
            outcomes.append(PairOutcome(name=name, ok=True, result=result))
            if metrics_path:
                record = {"pair": name, "ok": True}
                metrics = getattr(result, "metrics", None)
                if metrics:
                    record.update(metrics)
                append_jsonl(metrics_path, record)
        except Exception as exc:  # noqa: BLE001 — per-pair isolation is the point
            outcomes.append(
                PairOutcome(
                    name=name, ok=False,
                    error=f"{type(exc).__name__}: {exc}",
                )
            )
            if metrics_path:
                append_jsonl(metrics_path, {"pair": name, "ok": False,
                                            "error": str(exc)})
    return outcomes


def aggregate_metrics(outcomes: Sequence[PairOutcome]) -> Dict[str, float]:
    """Mean of numeric metrics over successful pairs + failure count."""
    sums: Dict[str, float] = {}
    count = 0
    for o in outcomes:
        if not o.ok:
            continue
        metrics = getattr(o.result, "metrics", None)
        if not metrics:
            continue
        count += 1
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0.0) + float(v)
    out = {k: v / max(count, 1) for k, v in sums.items()}
    out["num_ok"] = float(sum(o.ok for o in outcomes))
    out["num_failed"] = float(sum(not o.ok for o in outcomes))
    return out
