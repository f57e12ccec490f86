"""``img_per_s`` in the host-paced cell: the same reading, kept apart because
that cell's runs spread with the host's speed (§2 of PERF.md)."""

from benchmark.metrics.img_per_s import read  # noqa: F401
