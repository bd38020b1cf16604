"""Tests' parts of cell ``stage1.flagship``: Stage-1 epochs through
``Stage1Trainer.train_epoch`` (K2 b in training, on the CPU its plain
float32 version)."""

from portbench.tests.cells import SMALL_NET

SMALL = {"config": {"NetworkSpecs": SMALL_NET, "CodeLength": 16, "ScenesPerBatch": 4, "SamplesPerScene": 256},
         "traffic": {"scenes": 12, "rows_per_scene": 6000}}

CARD_SIZE = {"traffic": {"scenes": 128, "rows_per_scene": 100000}}

SPAN_METRICS = ("step_host_ms.train", "fetch_wait_ms.train")


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


FAULTS = {"state_unchanged": _adam_unchanged, "half_batch": _train_half_batch, "answer_altered": _train_loss_altered}
