"""The guided run of ``tests/test_torch_latent_pipeline.py``: a tiny
SD-like ``LDMPipeline.run`` under classifier-free guidance (the coco
recipe: PLMS, scale 7.5, two trajectory batches of 4 with their own
context rows, the doubled calibration rows, scale init, ``serve='int8'``)
against the JAX package's, held by that file's tests and bounds."""

import pytest

from test_torch_latent_pipeline import (run_both,  # noqa: F401 (collected tests)
                                        test_final_state_matches_jax,
                                        test_images_match_jax,
                                        test_serving_steps_match_jax,
                                        test_tdac_and_calibration_rows_match_jax)


@pytest.fixture(scope="module", params=["coco"])
def runs(request):
    return run_both(request.param)
