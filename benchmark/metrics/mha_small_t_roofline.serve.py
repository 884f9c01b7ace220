"""The mha_small_t kernel's share of its roofline in the traced section (%)."""

from benchmark.harness.readers import roofline_of

read = roofline_of("mha_small_t")
