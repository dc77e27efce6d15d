"""Sojourn-time metrics and ECDF helpers consumed by the benchmarks."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.simulator import SimResult


def ecdf(values: list[float]) -> tuple[np.ndarray, np.ndarray]:
    """Empirical CDF: returns (sorted values, cumulative probabilities)."""
    xs = np.sort(np.asarray(values, dtype=np.float64))
    ps = np.arange(1, len(xs) + 1) / len(xs)
    return xs, ps


@dataclass
class SojournSummary:
    mean: float
    median: float
    p95: float
    count: int

    @classmethod
    def of(cls, values: list[float]) -> "SojournSummary":
        if not values:
            return cls(0.0, 0.0, 0.0, 0)
        a = np.asarray(values, dtype=np.float64)
        return cls(
            float(a.mean()), float(np.median(a)), float(np.percentile(a, 95)),
            len(a),
        )


def per_class_sojourns(
    result: SimResult, class_of: dict[int, str]
) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for jid, s in result.sojourn.items():
        out.setdefault(class_of.get(jid, "?"), []).append(s)
    return out


def summarize(result: SimResult, class_of: dict[int, str]) -> dict[str, SojournSummary]:
    per = per_class_sojourns(result, class_of)
    out = {c: SojournSummary.of(v) for c, v in sorted(per.items())}
    out["all"] = SojournSummary.of(list(result.sojourn.values()))
    return out


def per_job_delta(a: SimResult, b: SimResult) -> dict[int, float]:
    """sojourn_a - sojourn_b per job (positive = b is better), Fig. 4."""
    sa, sb = a.sojourn, b.sojourn
    return {j: sa[j] - sb[j] for j in sa if j in sb}


#: Percentiles reported by scenario reports (compact ECDF summary).
ECDF_PERCENTILES = (5, 25, 50, 75, 90, 95, 99)


def ecdf_quantiles(
    values: list[float], percentiles: tuple[int, ...] = ECDF_PERCENTILES
) -> dict[str, float]:
    """Compact machine-readable ECDF: {"p50": ..., "p95": ...}.

    The full :func:`ecdf` is exact but O(n) wide; scenario reports store
    these fixed quantiles instead so JSON diffs across commits stay readable.
    """
    if not values:
        return {f"p{p}": 0.0 for p in percentiles}
    a = np.asarray(values, dtype=np.float64)
    return {
        f"p{p}": float(np.percentile(a, p)) for p in percentiles
    }


#: Tail percentiles for the tails report block (99.9 renders as "p999").
TAIL_PERCENTILES = (99, 99.9)


def tail_quantiles(
    values: list[float],
    percentiles: tuple[float, ...] = TAIL_PERCENTILES,
) -> dict[str, float]:
    """Extreme-tail quantiles: {"p99": ..., "p999": ...}.

    Labels drop the decimal point (99.9 -> "p999") so the report keys
    stay valid identifiers.  The ECDF quantiles stop at p95/p99; these
    are the tails the service telemetry and the bench gate watch.
    """
    labels = [
        "p" + (f"{p:g}".replace(".", "")) for p in percentiles
    ]
    if not values:
        return {lab: 0.0 for lab in labels}
    a = np.asarray(values, dtype=np.float64)
    return {
        lab: float(np.percentile(a, p))
        for lab, p in zip(labels, percentiles)
    }


def jain_index(values: list[float]) -> float:
    """Jain's fairness index: (sum x)^2 / (n * sum x^2), in (0, 1].

    1.0 means every job got exactly the same value (perfect fairness);
    1/n means one job got everything.  Computed over per-job slowdowns
    it is the standard fairness-of-slowdown measure for size-based
    disciplines (the "is HFSP unfair to large jobs?" question of
    Sect. 4.2).  Empty or all-zero input returns 1.0 (trivially fair).
    """
    if not values:
        return 1.0
    a = np.asarray(values, dtype=np.float64)
    denom = len(a) * float((a * a).sum())
    if denom <= 0:
        return 1.0
    return float(a.sum()) ** 2 / denom


def slowdowns(
    result: SimResult, size_of: dict[int, float]
) -> dict[int, float]:
    """Per-job slowdown: sojourn / serialized size.

    ``size_of`` maps job_id -> serialized job size (sum of task runtimes
    on one slot — the paper's size notion, Sect. 3.1).  A job whose
    sojourn equals its serialized size ran as if alone on one slot;
    values below 1 reflect parallel speedup, large values reflect
    queueing.  Jobs with non-positive size are skipped.
    """
    out: dict[int, float] = {}
    for jid, s in result.sojourn.items():
        size = size_of.get(jid, 0.0)
        if size > 0:
            out[jid] = s / size
    return out
