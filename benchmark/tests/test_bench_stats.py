"""The window's arithmetic: the image credit of a batch cut at the close
and the step-time percentile."""

import numpy as np
import pytest

from benchmark.lib.stats import credited_images, percentile


@pytest.mark.parametrize("finished, done, per_batch, images, decode, expect", [
    (2, 0, 100, 500, 0.0, 1000.0),           # closed at a batch boundary
    (2, 37, 100, 500, 0.0, 1185.0),          # 37 of 100 forwards of the third batch
    (0, 50, 51, 16, 0.0, 16 * 50 / 51),      # PLMS: 51 forwards a batch
    (1, 50, 51, 16, 0.045, 16 * (1 + 50 / 51 * 0.955)),  # its decode (4.5 %) not run
    (1, 51, 51, 4, 0.03, 4 * (1 + 0.97)),    # every forward done, the decode not yet
])
def test_credit_of_a_cut_batch(finished, done, per_batch, images, decode, expect):
    assert credited_images(finished, done, per_batch, images, decode) == pytest.approx(expect)


def test_p95_over_synthetic_steps():
    steps = [165.0] * 190 + [170.0] * 5 + [400.0] * 5   # five stalls in 200 gaps
    p = percentile(steps, 95)
    assert p == pytest.approx(np.percentile(steps, 95))   # linear between order statistics
    assert 165.0 <= p <= 170.0
    stalls = [165.0] * 180 + [400.0] * 20                 # ten percent stalls reach the tail
    assert percentile(stalls, 95) == 400.0


def test_percentile_needs_two_values():
    with pytest.raises(ValueError):
        percentile([1.0], 95)
