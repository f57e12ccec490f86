"""``python -m eda_dm_tpu_torch.validate_ptq`` (the port of
``scripts/validate_ptq.py``) on the CPU at the JAX script's tiny sizes:
PTQ → paired FP and quantized samples → the random-init Inception's
features → the standardized FID of one set against the other.  The result
has the JAX script's keys (read from its source), its numbers are finite,
``features.npz`` and ``result.json`` are written, and the quantized arm is
not the FP one.  Without ``--device cpu`` and without a card it raises.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from eda_dm_tpu_torch.validate_ptq import main

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "validate_ptq.py")


def _jax_result_keys():
    """The keys of the dict the JAX script's ``main`` writes as its result."""
    tree = ast.parse(open(SCRIPT).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict in scripts/validate_ptq.py")


def _run(tmp_path, argv):
    out = str(tmp_path / "run")
    res = main(argv + ["--out", out, "--device", "cpu"])
    assert set(res) == _jax_result_keys()
    with open(os.path.join(out, "result.json")) as f:
        assert json.load(f) == res
    feats = np.load(os.path.join(out, "features.npz"))
    assert feats["fp"].shape == feats["quant"].shape == (res["n"], 2048)
    assert np.isfinite(feats["fp"]).all() and np.isfinite(feats["quant"]).all()
    assert np.isfinite(res["fid_quant_vs_fp"]) and np.isfinite(res["split_noise_floor"])
    assert not np.allclose(feats["fp"], feats["quant"])
    assert not res["real_weights"] and not res["real_inception"]
    return res


def test_validate_cifar_tiny(tmp_path):
    res = _run(tmp_path, ["--task", "cifar", "--tiny", "--n", "8", "--batch_size", "4",
                          "--calib_num_samples", "8", "--iters", "2", "--timesteps", "4"])
    assert res["task"] == "cifar" and res["n"] == 8 and res["serve"] == "waq"


def test_validate_coco_tiny_int8(tmp_path):
    res = _run(tmp_path, ["--task", "coco", "--tiny", "--n", "4", "--batch_size", "2",
                          "--calib_num_samples", "4", "--batch_samples", "4",
                          "--iters", "2", "--custom_steps", "3", "--serve", "int8",
                          "--text_encoder", "tiny", "--no_recon"])
    assert res["serve"] == "int8" and res["task"] == "coco"


def test_validate_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--task", "cifar", "--tiny", "--n", "2", "--out", str(tmp_path / "x")])
