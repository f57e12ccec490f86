"""Small statistics of the benchmark: the window's image credit and the
percentiles of step times."""

from __future__ import annotations

import statistics
from typing import Sequence


def credited_images(finished: int, forwards_done: int, forwards_per_batch: int,
                    images_per_batch: int, decode_share: float = 0.0) -> float:
    """Images the window's work amounts to: finished batches whole, the
    batch running at the close by the share of its UNet forwards done,
    times the share of a batch's time that is not its decode (the cut
    batch's decode has not run)."""
    return images_per_batch * (finished + forwards_done / forwards_per_batch
                               * (1.0 - decode_share))


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile, linear between order statistics (Python's
    ``statistics.quantiles`` with ``method="inclusive"``)."""
    if len(values) < 2:
        raise ValueError("a percentile needs two values or more")
    return statistics.quantiles(values, n=100, method="inclusive")[int(round(p)) - 1]
