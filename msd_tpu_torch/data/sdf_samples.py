"""SDF sample files and the Stage-1 training set.

The on-disk contract is the reference's ``.npz`` with float32 ``pos``/``neg``
arrays of shape [N, 4] = (x, y, z, sdf) (ref: src/PreprocessMesh.cpp:196-226,
deep_sdf/data.py:83-136). Counterpart of ``msd_tpu/data/sdf_samples.py``:
every sample of the split is loaded once into padded device tensors, and the
per-step balanced pos/neg subsample is a random gather on the device
(``sample_sdf_batch``), so no batch crosses from the host per step.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from msd_tpu_torch.data.labels import labels_for_instances
from msd_tpu_torch.data.splits import get_instance_filenames, split_instance_ids

# Padded scene slabs are rounded up to a multiple of this, so any chunklet
# size dividing it tiles the slab exactly (no unreachable tail rows).
PAD_GRANULARITY = 128


def remove_nans(arr: np.ndarray) -> np.ndarray:
    """Drop rows whose SDF value is NaN (ref: deep_sdf/data.py:78-80)."""
    return arr[~np.isnan(arr[:, 3]), :]


def read_sdf_samples(filename):
    """Return (pos, neg) float32 arrays from a SdfSamples .npz
    (ref: deep_sdf/data.py:83-88)."""
    npz = np.load(filename)
    return np.asarray(npz["pos"], np.float32), np.asarray(npz["neg"], np.float32)


def pad_stack(arrays: List[np.ndarray]):
    """Stack variable-length [Ni, 4] arrays into [S, Nmax, 4] + counts [S].

    Padding tiles the scene's own rows cyclically, so every padded row is a
    valid sample row; Nmax is a multiple of ``PAD_GRANULARITY``."""
    counts = np.array([a.shape[0] for a in arrays], dtype=np.int32)
    if np.any(counts == 0):
        bad = int(np.argmax(counts == 0))
        raise ValueError(f"shape index {bad} has zero SDF samples")
    nmax = -(-int(counts.max()) // PAD_GRANULARITY) * PAD_GRANULARITY
    out = np.empty((len(arrays), nmax, 4), dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
        if a.shape[0] < nmax:
            reps = -(-(nmax - a.shape[0]) // a.shape[0])
            out[i, a.shape[0]:] = np.tile(a, (reps, 1))[: nmax - a.shape[0]]
    return out, counts


def sample_sdf_batch(pos, pos_counts, neg, neg_counts, scene_indices, subsample: int,
                     generator: torch.Generator, chunk: int = 128) -> torch.Tensor:
    """Balanced half-positive / half-negative subsample for a batch of
    scenes, drawn on the tensors' device (ref: deep_sdf/data.py:91-109).

    Rows are drawn in random *chunklets* of gcd(half, ``chunk``) rows of the
    pre-shuffled slab, as ``msd_tpu`` does; ``chunk=1`` draws every row iid
    and uniformly with replacement.

    pos/neg: [4, S, Pmax] SoA (``SdfDataset.device_arrays``); counts [S];
    scene_indices [B] long. Returns [4, B, subsample] float32."""
    half = subsample // 2
    b = scene_indices.shape[0]

    def draw(arr, counts, n_rows):
        r = max(math.gcd(n_rows, chunk), 1)
        n_draws = n_rows // r
        n_chunklets = arr.shape[2] // r
        # ceil-div so the partial tail chunklet is reachable (its pad rows
        # are cyclic copies of real rows)
        cc = ((counts[scene_indices] + r - 1) // r).clamp(1, n_chunklets)
        u = torch.rand(b, n_draws, generator=generator, device=arr.device)
        ic = torch.minimum((u * cc[:, None]).long(), cc[:, None] - 1)
        flat_ids = (scene_indices[:, None] * n_chunklets + ic).reshape(-1)
        chunked = arr[:, :, : n_chunklets * r].reshape(4, -1, r)
        return chunked[:, flat_ids].reshape(4, b, n_rows)

    return torch.cat([draw(pos, pos_counts, half), draw(neg, neg_counts, subsample - half)], dim=2)


def surface_clouds(data_source_mesh: str, instance_ids: List[str], count: int) -> np.ndarray:
    """[S, count, 3] float32 surface samples of each id's mesh, tried as
    ``id.obj``, ``id.ply``, then ``id`` under ``data_source_mesh``, all from
    one ``np.random.default_rng(0)`` in id order; a missing mesh gives a
    zero cloud and a warning (msd_tpu/data/sdf_samples.py:222-240; ref:
    deep_sdf/data.py:139-142, :209-217)."""
    from msd_tpu_torch.data.mesh_io import load_mesh
    from msd_tpu_torch.ops.sampling import sample_mesh_surface

    rng = np.random.default_rng(0)
    clouds = []
    for iid in instance_ids:
        path = next((p for p in (os.path.join(data_source_mesh, iid + ext) for ext in (".obj", ".ply", ""))
                     if os.path.isfile(p)), None)
        if path is None:
            logging.warning("Requested non-existent mesh file for '%s'", iid)
            clouds.append(np.zeros((count, 3), np.float32))
            continue
        v, f = load_mesh(path)
        clouds.append(sample_mesh_surface(v, f, count, rng)[0])
    return np.stack(clouds)


@dataclass
class SdfDataset:
    """All SDF samples of a split as padded arrays (host copies AoS
    [S, Nmax, 4]); ``device_arrays`` puts them on a device in SoA layout.
    ``labels`` [S, L] (NaN where an id has none) when a label map was
    given; ``surface_points`` [S, P, 3] float32, for the point encoders,
    when asked for."""

    npyfiles: List[str]
    instance_ids: List[str]
    pos: np.ndarray
    pos_counts: np.ndarray
    neg: np.ndarray
    neg_counts: np.ndarray
    subsample: int
    labels: Optional[np.ndarray] = None
    surface_points: Optional[np.ndarray] = None
    _device: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_split(cls, data_source: str, split, subsample: int, labels: Optional[dict] = None,
                   warn_missing_labels: bool = True, data_source_mesh: Optional[str] = None,
                   return_surface_points: bool = False, surface_point_count: int = 2048) -> "SdfDataset":
        """``labels``: an id -> vector map (``data.labels.load_labels``).
        ``return_surface_points``: a cloud of ``surface_point_count`` points
        per kept shape, sampled from its mesh under ``data_source_mesh``
        (``surface_clouds``)."""
        npyfiles = get_instance_filenames(data_source, split)
        instance_ids = split_instance_ids(split)
        pos_list, neg_list, keep_files, keep_ids = [], [], [], []
        shuffle_rng = np.random.default_rng(0)
        for f, iid in zip(npyfiles, instance_ids):
            try:
                p, n = read_sdf_samples(f)
            except (FileNotFoundError, OSError):
                logging.warning("skipping missing sample file '%s'", f)
                continue
            p, n = remove_nans(p), remove_nans(n)
            # pre-shuffle rows once so chunklet draws are uniform subsets
            # (ref: deep_sdf/data.py:199-206 shuffles on load)
            pos_list.append(p[shuffle_rng.permutation(p.shape[0])])
            neg_list.append(n[shuffle_rng.permutation(n.shape[0])])
            keep_files.append(f)
            keep_ids.append(iid)
        if not pos_list:
            raise RuntimeError(f"no sample files found under {data_source}")
        pos, pos_counts = pad_stack(pos_list)
        neg, neg_counts = pad_stack(neg_list)
        label_arr = None
        if labels is not None:
            label_arr = labels_for_instances(labels, keep_ids, warn_missing=warn_missing_labels)
        surface = None
        if return_surface_points:
            if not data_source_mesh:
                raise RuntimeError("data_source_mesh must be set when return_surface_points=True")
            surface = surface_clouds(data_source_mesh, keep_ids, surface_point_count)
        return cls(keep_files, keep_ids, pos, pos_counts, neg, neg_counts, subsample, label_arr, surface)

    def __len__(self):
        return len(self.npyfiles)

    @property
    def num_scenes(self):
        return len(self.npyfiles)

    def device_arrays(self, device):
        """(pos [4, S, Pmax], pos_counts [S], neg, neg_counts) on ``device``,
        cached."""
        key = str(torch.device(device))
        if key not in self._device:
            def soa(a):
                return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1))).to(device)

            def cnt(c):
                return torch.from_numpy(c.astype(np.int64)).to(device)

            self._device[key] = (soa(self.pos), cnt(self.pos_counts), soa(self.neg), cnt(self.neg_counts))
        return self._device[key]
