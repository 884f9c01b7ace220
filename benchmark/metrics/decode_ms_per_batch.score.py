"""Host ms to decode, tile and cut one batch of the cell's files with EvalLoader alone (host clock)."""

from benchmark.harness.readers import value

read = value("decode_ms_per_batch")
