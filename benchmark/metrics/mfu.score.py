"""Model operations of the clips scored in the measured window over the window's time, as a share of the card's bf16 peak (%)."""

from benchmark.harness.readers import mfu as read  # noqa: F401
