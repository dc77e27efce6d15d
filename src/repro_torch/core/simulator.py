"""Simulator helpers the accel path needs before the discrete-event
simulator itself is ported: the ``event_epsilon="auto"`` resolver."""

from __future__ import annotations


def auto_event_epsilon(
    arrivals: list[float], heartbeat: float = 3.0
) -> float:
    """Pick a coalescing window width from observed arrival burstiness.

    Burstiness is measured as the coefficient of variation (CV) of the
    inter-arrival gaps.  CV <= 1 (Poisson or smoother): return 0 — the
    stream has no bursts, so a window would only delay decisions without
    cutting pass counts.  CV > 1: return the *median* gap — in a bursty
    stream the median sits inside the bursts (most gaps are tiny), so a
    median-wide window merges each burst into one scheduling pass while
    the inter-burst gaps, far above the median, still get their own.
    Capped at one ``heartbeat`` so no decision is ever deferred longer
    than the executor's own tick, and 0 for fewer than 3 arrivals (one
    gap is not a distribution).  Pure and deterministic.
    """
    ts = sorted(arrivals)
    if len(ts) < 3:
        return 0.0
    gaps = [b - a for a, b in zip(ts, ts[1:])]
    mean = sum(gaps) / len(gaps)
    if mean <= 0.0:
        # Every arrival simultaneous: any window merges them; one
        # heartbeat is the largest we ever allow.
        return float(heartbeat)
    var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
    cv = (var ** 0.5) / mean
    if cv <= 1.0:
        return 0.0
    med = sorted(gaps)[len(gaps) // 2]
    return float(min(med, heartbeat))
