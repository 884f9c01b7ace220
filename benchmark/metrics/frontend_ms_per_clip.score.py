"""Device ms a clip of the conv feature extractor alone on one batch of the cell (CUDA events)."""

from benchmark.harness.readers import value

read = value("frontend_ms_per_clip")
