"""Share of the traced scoring call with no operation on the device (%)."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
