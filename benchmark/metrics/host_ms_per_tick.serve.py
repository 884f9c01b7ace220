"""Host ms a traced tick in which no operation ran on the device: the tick's wall less the device's busy time within it."""

from benchmark.harness.readers import value

read = value("host_ms_per_tick")
