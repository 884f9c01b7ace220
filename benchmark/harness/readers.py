"""What the per-layer metric files read from a run's readings. A reader
returns ``None`` where the run has nothing to read, and the harness then
leaves the metric out of the result line."""

from __future__ import annotations

from typing import Optional


def value(key: str):
    def read(r: dict) -> Optional[float]:
        return r.get(key)
    return read


def roofline_of(kernel: str):
    """A hand-written kernel's share of its roofline (%): the least time
    its launches could take, from their shapes (``bound_s.<kernel>``),
    over the time they took in the trace (``kernel_s.<kernel>``)."""
    def read(r: dict) -> Optional[float]:
        if not r.get("kernel_s." + kernel):
            return None
        return 100.0 * r["bound_s." + kernel] / r["kernel_s." + kernel]
    return read


def share_of_peak(flops: str, seconds: str):
    """Model operations (``flops``) over the seconds they took
    (``seconds``), as a share of the card's peak (%)."""
    def read(r: dict) -> Optional[float]:
        if not r.get(seconds) or flops not in r:
            return None
        return 100.0 * r[flops] / r[seconds] / r["peak_flops"]
    return read


# model operations of the answers over the seconds they took
mfu = share_of_peak("model_flops", "mfu_seconds")


def idle_share(r: dict) -> Optional[float]:
    """The share of the traced span with no operation on the device (%);
    nothing where the device ran nothing (a CPU run)."""
    if not r.get("idle_busy_s") or not r.get("idle_span_s"):
        return None
    return 100.0 * (1.0 - r["idle_busy_s"] / r["idle_span_s"])
