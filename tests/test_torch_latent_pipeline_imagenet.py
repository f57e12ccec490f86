"""The class-conditional run of ``tests/test_torch_latent_pipeline.py``: a
tiny ImageNet-like ``LDMPipeline.run`` under classifier-free guidance (the
imagenet recipe: DDIM at eta 0, scale 3.0; a one-head spatial transformer
over a one-token class context of 24 from a 1001-row embedder; 8 labels
from ``imagenet_labels`` and 8 unconditional rows at label 1000, each
package's embedder giving equal contexts; two trajectory batches of 4,
the doubled calibration rows, scale init, ``serve='int8'``, 2 images)
against the JAX package's, held by that file's tests and bounds.  As in
the coco run, the reconstruction is left out (``recon=False``): each JAX
compile of a target's loop costs seconds, and ``tests/test_torch_ldm_calib.py``
holds the transformer block's loop with its context."""

import pytest

from test_torch_latent_pipeline import (run_both,  # noqa: F401 (collected tests)
                                        test_final_state_matches_jax,
                                        test_images_match_jax,
                                        test_serving_steps_match_jax,
                                        test_tdac_and_calibration_rows_match_jax)


@pytest.fixture(scope="module", params=["imagenet"])
def runs(request):
    return run_both(request.param)
