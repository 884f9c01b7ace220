"""Device ms a clip of the projection, positional conv and transformer layers alone on one batch's conv features (CUDA events)."""

from benchmark.harness.readers import value

read = value("encoder_ms_per_clip")
