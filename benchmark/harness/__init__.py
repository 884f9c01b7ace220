"""The benchmark's own machinery: run set-up, weights, device checks,
trace reading and the comparison that decides ``correct``."""
