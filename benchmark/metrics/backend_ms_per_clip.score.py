"""Device ms a clip of the AASIST back-end alone on one batch's encoder output (CUDA events)."""

from benchmark.harness.readers import value

read = value("backend_ms_per_clip")
