"""What the per-layer metric files read from a run's readings. A reader
returns ``None`` where the run has nothing to read, and the harness then
leaves the metric out of the result line."""

from __future__ import annotations

from typing import Optional


def value(key: str):
    def read(r: dict) -> Optional[float]:
        return r.get(key)
    return read


def roofline(r: dict) -> Optional[float]:
    """The attention kernel's share of its roofline (%): the least time
    its launches could take, from their shapes, over the time they took
    in the trace."""
    if not r.get("attn_kernel_s"):
        return None
    return 100.0 * r["attn_bound_s"] / r["attn_kernel_s"]


def mfu(r: dict) -> Optional[float]:
    """Model operations of the answers over the seconds they took
    (``mfu_seconds``), as a share of the card's peak (%)."""
    if not r.get("mfu_seconds") or "model_flops" not in r:
        return None
    return 100.0 * r["model_flops"] / r["mfu_seconds"] / r["peak_flops"]


def idle_share(r: dict) -> Optional[float]:
    """The share of the traced span with no operation on the device (%);
    nothing where the device ran nothing (a CPU run)."""
    if not r.get("idle_busy_s") or not r.get("idle_span_s"):
        return None
    return 100.0 * (1.0 - r["idle_busy_s"] / r["idle_span_s"])
