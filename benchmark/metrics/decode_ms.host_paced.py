"""``decode_ms`` in the host-paced cell: the same reading, kept apart because
that cell's runs spread with the host's speed (§2 of PERF.md)."""

from benchmark.metrics.decode_ms import read  # noqa: F401
