"""msd_tpu_torch's Stage-1 training set and point sampler on the CPU: the
dataset equals msd_tpu's on the same files (NaN rows dropped, one
pre-shuffle, cyclic padding to a multiple of 128), and the sampler draws a
balanced half/half batch of valid rows, uniformly when ``chunk=1``."""

import os

import numpy as np
import pytest
import torch

from msd_tpu.data.sdf_samples import SdfDataset as JaxDataset
from msd_tpu_torch.data.sdf_samples import PAD_GRANULARITY, SdfDataset, sample_sdf_batch


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four scenes with uneven counts and a few NaN rows."""
    root = str(tmp_path_factory.mktemp("sdf"))
    rng = np.random.default_rng(0)
    names = []
    for i, (n_pos, n_neg) in enumerate([(300, 200), (7, 129), (1000, 999), (128, 5)]):
        pos = np.concatenate([rng.uniform(-1, 1, (n_pos, 3)), rng.uniform(0.0, 0.1, (n_pos, 1))], 1)
        neg = np.concatenate([rng.uniform(-1, 1, (n_neg, 3)), rng.uniform(-0.1, -1e-3, (n_neg, 1))], 1)
        pos[::50, 3] = np.nan
        np.savez(os.path.join(root, f"s{i}.npz"), pos=pos.astype(np.float32), neg=neg.astype(np.float32))
        names.append(f"s{i}.obj")
    return root, names


def test_dataset_equals_msd_tpu(data):
    root, names = data
    ours, theirs = SdfDataset.from_split(root, names, 256), JaxDataset.from_split(root, names, 256)
    assert ours.instance_ids == theirs.instance_ids and ours.npyfiles == theirs.npyfiles
    for a, b in ((ours.pos, theirs.pos), (ours.neg, theirs.neg),
                 (ours.pos_counts, theirs.pos_counts), (ours.neg_counts, theirs.neg_counts)):
        np.testing.assert_array_equal(a, b)
    assert ours.pos.shape[1] % PAD_GRANULARITY == 0 and not np.isnan(ours.pos).any()
    assert list(ours.pos_counts) == [294, 6, 980, 125]
    pos, pc, neg, nc = ours.device_arrays("cpu")
    assert pos.shape == (4, 4, ours.pos.shape[1]) and torch.equal(pc, torch.tensor([294, 6, 980, 125]))
    np.testing.assert_array_equal(pos.permute(1, 2, 0).numpy(), ours.pos)


@pytest.mark.parametrize("chunk", [128, 1])
def test_batch_is_balanced_and_valid(data, chunk):
    root, names = data
    ds = SdfDataset.from_split(root, names, 256)
    pos, pc, neg, nc = ds.device_arrays("cpu")
    idx = torch.tensor([2, 0, 1, 3])
    batch = sample_sdf_batch(pos, pc, neg, nc, idx, 256, torch.Generator().manual_seed(1), chunk=chunk)
    assert batch.shape == (4, 4, 256)
    assert (batch[3, :, :128] > 0).all() and (batch[3, :, 128:] < 0).all()
    for b, s in enumerate(idx.tolist()):
        for rows, arr, count in ((batch[:, b, :128], ds.pos[s], ds.pos_counts[s]),
                                 (batch[:, b, 128:], ds.neg[s], ds.neg_counts[s])):
            real = {tuple(r) for r in arr[:count]}
            assert all(tuple(r) in real for r in rows.t().numpy())


def test_chunk_one_draws_uniformly(data):
    """Scene 1 has 6 positive rows: 64 draws of 128 rows each pick every row
    with frequency 1/6; each count stays within 10% of 8192/6 (binomial
    standard deviation 1.2%)."""
    root, names = data
    ds = SdfDataset.from_split(root, names, 256)
    pos, pc, neg, nc = ds.device_arrays("cpu")
    gen = torch.Generator().manual_seed(2)
    drawn = torch.cat([sample_sdf_batch(pos, pc, neg, nc, torch.tensor([1]), 256, gen, chunk=1)[3, 0, :128]
                       for _ in range(64)])
    values, counts = torch.unique(drawn, return_counts=True)
    assert len(values) == 6
    expected = drawn.numel() / 6
    assert (counts.float() - expected).abs().max() <= 0.1 * expected
