"""Dispatches the engine made a tick over the measured window (its dispatch_counts)."""

from benchmark.harness.readers import value

read = value("dispatches_per_tick")
