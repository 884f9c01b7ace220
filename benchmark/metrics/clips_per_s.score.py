"""Clips scored in the measured window over the window's whole time, loader included (host clock)."""

from benchmark.harness.readers import value

read = value("clips_per_s")
