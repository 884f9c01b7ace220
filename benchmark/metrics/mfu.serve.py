"""Model operations of the windows that the traced ticks' polls returned, over the device's busy seconds within those ticks, as a share of the card's bf16 peak (%)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
