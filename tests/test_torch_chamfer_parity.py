"""The port's copy of the toy Chamfer-parity protocol regenerates the exact
dataset of benchmarks/chamfer_parity.py (the bytes chamfer_parity.json's
rows were trained on)."""

import os
import sys

import numpy as np

from msd_tpu_torch import chamfer_parity as port

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))
import chamfer_parity as reference  # noqa: E402


def test_dataset_is_the_protocols():
    scenes, gt, sha = port.make_dataset()
    _, ref_scenes, ref_gt, ref_sha = reference.make_dataset()
    assert sha == ref_sha == port.DATASET_SHA
    for (p, n), (rp, rn) in zip(scenes, ref_scenes):
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(n, rn)
    for a, b in zip(gt, ref_gt):
        np.testing.assert_array_equal(a, b)

