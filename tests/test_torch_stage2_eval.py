"""msd_tpu_torch's Stage-2 data and eval pieces against msd_tpu's on the CPU:
label files in every format, crossing both ways; the label matrix with its
``_femur`` fallback and NaN fill; spec-relative paths; and the eval blocks'
correlation, age table and regression SAP on the same VAE weights."""

import os

import numpy as np
import pytest

from msd_tpu.config import resolve_spec_path as jax_resolve
from msd_tpu.data import labels as jax_labels
from msd_tpu.data.sdf_samples import _labels_for_instances as jax_for_instances
from msd_tpu.train import stage2_eval as jax_ev
from msd_tpu.train.stage2 import Stage2Trainer as JaxTrainer
from msd_tpu_torch.config import resolve_spec_path
from msd_tpu_torch.data import labels
from msd_tpu_torch.train import stage2_eval as ev
from msd_tpu_torch.train.stage2 import Stage2Trainer
from test_torch_stage2 import experiment, port_from_jax

LABELS = {"a": np.array([1.0, 63.5], np.float32), "b_femur": np.array([0.0, 71.0], np.float32),
          "c": np.array([np.nan, 80.25], np.float32)}


@pytest.mark.parametrize("ext", [".pt", ".npz", ".json"])
def test_label_files_cross_both_ways(tmp_path, ext):
    ours, theirs = str(tmp_path / ("ours" + ext)), str(tmp_path / ("theirs" + ext))
    labels.save_labels(ours, LABELS)
    jax_labels.save_labels(theirs, LABELS)
    for a, b in ((labels.load_labels(theirs), jax_labels.load_labels(ours)),
                 (labels.load_labels(ours), LABELS)):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(FileNotFoundError):
        labels.load_labels(str(tmp_path / "missing.pt"))


def test_labels_for_instances_matches_jax():
    """Exact ids, the ``_femur`` suffix fallback, and NaN for a missing id."""
    ids = ["a", "b_femur", "c_femur", "d"]
    label_map = dict(LABELS, c=np.array([1.0, 2.0], np.float32))
    ours = labels.labels_for_instances(label_map, ids, warn_missing=False)
    np.testing.assert_array_equal(ours, jax_for_instances(label_map, ids, warn_missing=False))
    assert np.isnan(ours[3]).all() and ours[2, 1] == 2.0


def test_resolve_spec_path_matches_jax(tmp_path):
    os.makedirs(tmp_path / "exp")
    (tmp_path / "exp" / "here.pth").write_text("")
    for path in (None, "here.pth", "../elsewhere.pth", str(tmp_path / "abs.pth"), "~/x.pth"):
        assert resolve_spec_path(path, str(tmp_path / "exp")) == jax_resolve(path, str(tmp_path / "exp"))


def test_eval_tables_match_jax(tmp_path):
    """On msd_tpu's VAE weights: latent-label correlation, the age table
    (corr, regression SAP, prediction mean and std) and the regression SAP
    of the age label, to 1e-4 (the mu differ by float32 rounding)."""
    exp = experiment(tmp_path, ComputeSAP=True, ComputeSAPAge=True)
    jt, port = JaxTrainer(exp), Stage2Trainer(exp, device="cpu")
    port_from_jax(port, jt)
    jt.epoch = port.epoch = 3
    idx = port.train_indices
    c_ours = ev.compute_latent_label_correlation(port, 3, "train", idx)
    c_ref = jax_ev.compute_latent_label_correlation(jt, 3, "train", idx)
    np.testing.assert_allclose(c_ours, c_ref, rtol=1e-4)
    os.makedirs(tmp_path / "jax", exist_ok=True)
    jt.experiment_directory = str(tmp_path / "jax")
    rows = []
    for tr, fn in ((port, ev.write_age_table), (jt, jax_ev.write_age_table)):
        with open(fn(tr, 3, "train", idx)) as f:
            rows.append(np.array([[float(v) for v in line.split(",")] for line in f.read().splitlines()[1:]]))
    np.testing.assert_allclose(rows[0], rows[1], rtol=1e-4, atol=1e-5)
    m_ours = ev.compute_disentanglement_metrics(port, 3, "train", idx)
    m_ref = jax_ev.compute_disentanglement_metrics(jt, 3, "train", idx)
    np.testing.assert_allclose(m_ours["sap_age"], m_ref["sap_age"], rtol=1e-4, atol=1e-6)
    assert m_ours["sap"] is not None and 0.0 <= m_ours["sap"] <= 1.0
