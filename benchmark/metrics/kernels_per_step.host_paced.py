"""``kernels_per_step`` in the host-paced cell: the same reading, kept apart because
that cell's runs spread with the host's speed (§2 of PERF.md)."""

from benchmark.metrics.kernels_per_step import read  # noqa: F401
