"""Model operations of the traced scoring call's clips over the card's busy seconds in it, as a share of the card's bf16 peak (%)."""

from benchmark.harness.readers import share_of_peak

read = share_of_peak("card_flops", "card_busy_s")
