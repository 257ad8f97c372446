"""Shared arithmetic of the metric readers in metrics/: each reader takes
the run's record and returns its value, or None where the record holds
nothing for it (the harness then leaves the metric out)."""

from __future__ import annotations

from harness import roofline

BF16_PEAK = roofline.PEAK_BF16


def per(record: dict, stages, unit: str, scale: float = 1.0):
    """Seconds of the named StageTimer stages (prefixes) over the count of
    `unit` in the units the StageTimer timed (those after the profiled
    ones), times `scale`."""
    seconds = record.get("stages")
    n = record.get("stage_work", {}).get(unit)
    if seconds is None or not n:
        return None
    total = sum(v for k, v in seconds.items() if k.startswith(tuple(stages)))
    return scale * total / n


def rate(record: dict, unit: str):
    """Wall seconds of the window per unit of work."""
    n = record.get("work", {}).get(unit)
    return record["window_wall_s"] / n if n else None


def mfu(record: dict, unit: str):
    """Percent of the bf16 peak: the model FLOPs of the untraced part of
    the window's work over its wall time."""
    flops = record.get("flops_per_work", {}).get(unit)
    n = record.get("untraced_work", {}).get(unit)
    if not flops or not n:
        return None
    return 100.0 * flops * n / (record["untraced_wall_s"] * BF16_PEAK)


def idle(record: dict):
    """Percent of the profiled units' window in which no kernel or copy
    ran."""
    if not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
