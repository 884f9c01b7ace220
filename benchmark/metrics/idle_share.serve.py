"""Share of the traced ticks (push and poll, not the pacing sleep between them) with no operation on the device (%)."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
