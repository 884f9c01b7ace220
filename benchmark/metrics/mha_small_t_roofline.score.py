"""The mha_small_t kernel's share of its roofline in the traced section (%)."""

from benchmark.harness.readers import roofline as read  # noqa: F401
