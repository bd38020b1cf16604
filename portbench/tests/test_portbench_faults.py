"""A run with the program broken underneath reads ``correct`` false: for
each fault a cell can have, planted in the program, the harness's run on
the CPU (past its look for a card) at a tiny size. One card, so no cell
has an exchange between chips to leave out."""

import numpy as np
import pytest

from portbench.run import run_cell
from portbench.tests.conftest import SMALL


def _run(cell, monkeypatch, plant):
    plant(monkeypatch)
    return run_cell(cell, 2**31 + 101, 0.3, False, device="cpu", overrides=SMALL[cell])


def _adam_unchanged(mp):
    from msd_tpu_torch.utils import optim

    def step(self, lrs, max_norm=None, clip_groups=("net",)):
        self.count += 1
        return {}

    mp.setattr(optim.GroupAdam, "step", step)


def _train_half_batch(mp):
    from msd_tpu_torch.train import stage1

    real = stage1.fused_sdf_loss

    def half(decoder, lat_rows, xyz, gt, clamp, use_eik, num_total, **kw):
        h = xyz.shape[0] // 2
        return real(decoder, lat_rows[:h], xyz[:h], gt[:h], clamp, use_eik, num_total // 2, **kw)

    mp.setattr(stage1, "fused_sdf_loss", half)


def _train_loss_altered(mp):
    from msd_tpu_torch.train import stage1

    real = stage1.fused_sdf_loss

    def altered(*a, **kw):
        total, sdf, eik = real(*a, **kw)
        return total, sdf * 1.05, eik

    mp.setattr(stage1, "fused_sdf_loss", altered)


def _fit_unchanged(mp):
    from msd_tpu_torch.train import reconstruct

    real = reconstruct.reconstruct_step

    def step(decoder, cfg, latent, m, v, it, batch, dm, ds):
        _, m, v, loss = real(decoder, cfg, latent, m, v, it, batch, dm, ds)
        return latent.detach(), m, v, loss

    mp.setattr(reconstruct, "reconstruct_step", step)


def _fit_half_batch(mp):
    from msd_tpu_torch.train import reconstruct

    real = reconstruct.reconstruct_loss

    def half(decoder, cfg, latent, batch, dm, ds):
        return real(decoder, cfg, latent, batch[:, : batch.shape[1] // 2], dm, ds)

    mp.setattr(reconstruct, "reconstruct_loss", half)


def _mesh_altered(mp):
    from msd_tpu_torch import mesh

    real = mesh.create_mesh

    def shifted(*a, **kw):
        res = real(*a, **kw)
        if res is False or res is True:
            return res
        verts, faces = res
        h = 2.0 / (mesh._snap_n(kw["N"]) - 1)
        return verts + np.float32(0.3 * h) * np.array([1, 0, 0], np.float32), faces

    mp.setattr(mesh, "create_mesh", shifted)


FAULTS = [
    ("stage1.flagship", "state_unchanged", _adam_unchanged),
    ("stage1.flagship", "half_batch", _train_half_batch),
    ("stage1.flagship", "answer_altered", _train_loss_altered),
    ("serve.flagship-b8", "state_unchanged", _fit_unchanged),
    ("serve.flagship-b8", "half_batch", _fit_half_batch),
    ("serve.flagship-b8", "answer_altered", _mesh_altered),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_reads_incorrect(cell, fault, plant, monkeypatch):
    out = _run(cell, monkeypatch, plant)
    assert out["correct"] is False
    failing = [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]
    assert failing, out["checks"]
