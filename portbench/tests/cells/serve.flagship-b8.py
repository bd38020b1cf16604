"""Tests' parts of cell ``serve.flagship-b8``: the reconstruct CLI's
``--batch`` loop, the fit and the streamed mesh (K1 and the fit's kernel,
on the CPU their plain float32 versions)."""

import numpy as np

from portbench.tests.cells import SMALL_NET

SMALL = {"config": {"NetworkSpecs": SMALL_NET, "CodeLength": 16},
         "traffic": {"shapes_per_batch": 2, "iterations": 400, "samples": 512, "mesh_resolution": 32,
                     "rows_per_shape": 6000, "family": 16, "family_steps": 400, "family_points": 1024,
                     "family_lr": 2e-3,
                     "check_vertices": 500, "eval_samples": 2048}}

CARD_SIZE = {"traffic": {"rows_per_shape": 100000, "sample_sets": 1}}

SPAN_METRICS = ("mesher_busy_s_per_shape.serve", "mesh_tail_s_per_shape.serve")


def traced_cpu(monkeypatch, overrides):
    """Stream the meshes as on the card (``_streams`` on for a CPU
    evaluator), at a resolution that refines in blocks."""
    from msd_tpu_torch import mesh

    monkeypatch.setattr(mesh, "_streams", lambda evaluator: True)
    overrides["traffic"]["mesh_resolution"] = 97
    overrides["config"]["NetworkSpecs"] = dict(overrides["config"]["NetworkSpecs"], dims=[32] * 4, latent_in=[2])


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


FAULTS = {"state_unchanged": _fit_unchanged, "half_batch": _fit_half_batch, "answer_altered": _mesh_altered}
