"""Stage-1 DeepSDF auto-decoder trainer (counterpart of
``msd_tpu/train/stage1.py``), on one device or data-parallel over ranks.

One step: CodeBound renorm of the batch's latent rows, a balanced pos/neg
point draw on the device, the clamped-L1 + eikonal loss and every gradient
through K2 (``ops/fused_train.py``; its CUDA kernels on a GPU) or through
autograd, the code regularizer, then gradient clipping on the decoder and
the two-group Adam step. All SDF samples live on the device; per-step
metrics stay there and are fetched once per epoch.

Path choice, as ``msd_tpu/train/stage1.py:308-340``: K2 when
``UseFusedTrainKernel`` is not false, ``MatmulPrecision`` is bf16 (the
default), there is no dropout, and ``supports_fused_train`` holds. K2's
operands are bf16 on a GPU; on the CPU its plain version runs in float32,
as ``msd_tpu`` on the CPU runs its bf16 precision in float32. Otherwise
the autograd path runs: the decoder's forward, the eikonal by
``torch.autograd.grad(..., create_graph=True)``, all in float32 with TF32
off. ``EikonalNumPoints`` E (``msd_tpu/train/stage1.py:111-118``) puts the
eikonal on the first E points of each scene: K2 variant c gates on its
tiled count (``fused_train.eikonal_rows``), the autograd path on E itself
(:431-466), as ``msd_tpu``.

Data-parallel (``group=``, a ``parallel.DataParallelGroup``; the
counterpart of ``Stage1Trainer(mesh=)``, reached through the API only, as
there): every rank draws the batch's points as the single-process trainer
does, pads the batch with scenes that alias scene 0 to a multiple of the
world size, and runs K2 on its share of the scenes; pad scenes carry
weight 0 (variant e) and CodeBound and the code regulariser see the real
scenes only (:577-616). The losses and the decoder and latent gradients
are summed over the ranks (``all_reduce``), so every rank's clip and
Adam step are the single-device step. Unlike ``msd_tpu``, which pads the
latent table and shards it over the mesh, the table is replicated on
every rank; checkpoints are the same either way (``msd_tpu`` strips its
padding), so they cross between the two and between any rank counts.
Only rank 0 writes checkpoints, logs and TensorBoard; every rank resumes.

Differences from ``msd_tpu`` (documented): the random streams (torch
generators, not JAX keys), so runs of the two packages draw different
points from the same seed; the scene batches come from the same numpy
generator and agree. Epoch blocks (``train/epoch_blocks.py``) were a relay
workaround and are not ported.

The latent regularizers (``losses/stage1.py``). Covariance and the GMM
prior act on the batch's real latent rows after the CodeBound projection,
once per step (:555-574, :660-671); their gradients add to what K2 or
autograd gave, after the sum over ranks, so every rank adds them once.
The GMM parameters train as a third optimizer group "gmm" at the latent
learning rate, unclipped; like ``msd_tpu`` the checkpoint keeps their Adam
moments and not the parameters, which a resumed run initialises afresh
from the seed. Isometry and grad-metric isotropy take the autograd path,
as they turn K2 off in ``msd_tpu`` (:322-323): per ``batch_split`` chunk,
on near-surface points of the chunk's real scenes (or a random
``IsometryScenesPerBatch`` of them), all scenes in one decoder call;
over ranks rank 0 adds them. Their draws (point selection noise, probes,
mixup) come from the step's generator and a numpy generator seeded by
(Seed, step). Stage 1 trains ``deep_sdf_decoder`` only: ``msd_tpu``'s
trainer cannot checkpoint another decoder (its ``save_model`` needs
``params_to_torch_state_dict``, which only ``DeepSDFDecoder`` has).

``ProfileEpochs`` (a list of epochs) runs each listed epoch's training
under ``torch.profiler`` and writes its trace to
``<exp>/TensorBoard/profile`` as ``rank<r>.<ns>.pt.trace.json`` (read by
TensorBoard's PyTorch profiler plugin or as a Chrome trace), as
``msd_tpu`` writes a ``jax.profiler`` trace there (:963-968). Over a group
each rank is a process and writes its own file; ``msd_tpu`` traces every
device of its one process into one. On the card the trace records CUDA
activity and the epoch raises rather than write a trace with no device
event in it.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.config import get_spec_with_default, note_noop_keys, validate_stage1_specs
from msd_tpu_torch.data.sdf_samples import SdfDataset, sample_sdf_batch
from msd_tpu_torch.data.splits import load_split
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.losses.sdf import code_regularization, safe_l2norm
from msd_tpu_torch.losses.stage1 import (
    covariance_loss,
    gmm_prior_init,
    gmm_prior_loss,
    grad_metric_isotropy_loss,
    isometry_loss,
    select_near_surface_points,
)
from msd_tpu_torch.lr_schedules import StepLearningRateOnPlateauSchedule, get_learning_rate_schedules
from msd_tpu_torch.models import DeepSDFDecoder, build_decoder
from msd_tpu_torch.ops.fused_train import fused_sdf_loss, supports_fused_train
from msd_tpu_torch.parallel import pad_to_multiple
from msd_tpu_torch.utils import checkpoint as ckpt
from msd_tpu_torch.utils.logging_utils import open_summary_writer
from msd_tpu_torch.utils.optim import GroupAdam, project_code_bound

# MatmulPrecision spec values that keep the bf16 products K2 computes in
# (msd_tpu/train/stage1.py:64-70); every other value runs float32 autograd.
_BF16_PRECISIONS = ("default", "bfloat16")


def step_seed(seed: int, step: int) -> int:
    """Seed of the point draw of global step ``step``: a resumed run draws
    what an unbroken run would."""
    return (int(seed) * 1_000_003 + int(step)) % (2**63)


class Stage1Trainer:
    def __init__(self, experiment_directory: str, specs: dict | None = None,
                 dataset: SdfDataset | None = None, device="cuda", group=None):
        """``group``: a ``parallel.DataParallelGroup`` to train
        data-parallel over its ranks (on its device); None trains on
        ``device`` alone."""
        self.group = group
        self.device = resolve_device(group.device if group is not None else device)
        self.experiment_directory = experiment_directory
        self.specs = specs if specs is not None else ws.load_experiment_specifications(experiment_directory)
        specs = self.specs
        validate_stage1_specs(specs)
        note_noop_keys(specs)
        logging.info("Experiment description: \n%s", specs.get("Description", "(none)"))

        self.data_source = specs["DataSource"]
        self.latent_size = specs["CodeLength"]
        self.num_epochs = specs["NumEpochs"]
        self.num_samp_per_scene = specs["SamplesPerScene"]
        self.scene_per_batch = specs["ScenesPerBatch"]
        self.clamp_dist = specs["ClampingDistance"]
        self.snapshot_frequency = specs["SnapshotFrequency"]
        self.additional_snapshots = get_spec_with_default(specs, "AdditionalSnapshots", [])
        self.checkpoints = sorted(
            list(range(self.snapshot_frequency, self.num_epochs + 1, self.snapshot_frequency))
            + list(self.additional_snapshots)
        )
        self.log_frequency = get_spec_with_default(specs, "LogFrequency", 200)
        self.grad_clip = get_spec_with_default(specs, "GradientClipNorm", None)
        self.code_bound = get_spec_with_default(specs, "CodeBound", None)
        self.do_code_regularization = get_spec_with_default(specs, "CodeRegularization", True)
        self.code_reg_lambda = get_spec_with_default(specs, "CodeRegularizationLambda", 1e-4)
        self.use_eikonal = get_spec_with_default(specs, "UseEikonal", False)
        eik_points = get_spec_with_default(specs, "EikonalNumPoints", None)
        self.eikonal_num_points = int(eik_points) if eik_points else None
        self.seed = get_spec_with_default(specs, "Seed", 0)
        self.lr_schedules = get_learning_rate_schedules(specs)
        # latent regularizers, with msd_tpu's defaults (msd_tpu/train/stage1.py:119-143)
        self.use_covariance = get_spec_with_default(specs, "UseCovarianceLoss", False)
        self.lambda_cov = get_spec_with_default(specs, "CovarianceLossLambda", 1e-3)
        self.use_gmm_prior = get_spec_with_default(specs, "UseGMMPriorLoss", False)
        self.gmm_lambda = get_spec_with_default(specs, "GMMLambda", 1e-4)
        self.gmm_k = get_spec_with_default(specs, "GMMK", 2)
        self.gmm_init_sigma = get_spec_with_default(specs, "GMMInitSigma", 0.5)
        self.gmm_min_sigma = get_spec_with_default(specs, "GMMMinSigma", 0.05)
        self.gmm_learn_pi = get_spec_with_default(specs, "GMMLearnPi", False)
        self.use_isometry = get_spec_with_default(specs, "UseIsometryLoss", False)
        self.lambda_iso = get_spec_with_default(specs, "IsometryLossLambda", 1e-3)
        self.iso_num_points = get_spec_with_default(specs, "IsometryNumPoints", 256)
        self.iso_num_probes = get_spec_with_default(specs, "IsometryNumProbes", 1)
        get_spec_with_default(specs, "IsometryComputeFrequency", 1)  # read and unused, as in msd_tpu
        iso_cap = get_spec_with_default(specs, "IsometryScenesPerBatch", None)
        self.iso_scenes_per_batch = int(iso_cap) if iso_cap else None
        self.use_isometry_mixup = get_spec_with_default(specs, "UseIsometryMixup", False)
        self.iso_mixup_alpha = get_spec_with_default(specs, "IsometryMixupAlpha", 0.2)
        self.iso_mixup_prob = get_spec_with_default(specs, "IsometryMixupProb", 0.0)
        self.use_grad_metric_iso = get_spec_with_default(specs, "UseGradMetricIsotropyLoss", False)
        self.grad_metric_iso_lambda = get_spec_with_default(specs, "GradMetricIsoLossLambda", 1.0)
        self.grad_metric_iso_alpha = get_spec_with_default(specs, "GradMetricIsoAlpha", 1.0)
        self.grad_metric_iso_normalize = get_spec_with_default(specs, "GradMetricIsoNormalize", True)

        # --- decoder and latents ---
        gen = torch.Generator().manual_seed(self.seed)
        self.decoder = build_decoder(specs["NetworkArch"], self.latent_size, specs["NetworkSpecs"], generator=gen)
        if not isinstance(self.decoder, DeepSDFDecoder):
            raise NotImplementedError(
                f"NetworkArch {specs['NetworkArch']!r}: Stage 1 trains deep_sdf_decoder only; msd_tpu's trainer "
                "cannot checkpoint another decoder (its save_model needs params_to_torch_state_dict, which only "
                "DeepSDFDecoder has)")
        if get_spec_with_default(specs, "UsePretrainedSDFDecoder", False):
            self._load_pretrained_decoder()
        self.decoder = self.decoder.to(self.device).train()
        self.train_dropout = bool(self.decoder.dropout) and self.decoder.dropout_prob > 0

        if dataset is None:
            dataset = SdfDataset.from_split(self.data_source, load_split(specs["TrainSplit"]), self.num_samp_per_scene)
        self.dataset = dataset
        self.num_scenes = dataset.num_scenes
        logging.info("There are %d scenes", self.num_scenes)
        code_init_std = get_spec_with_default(specs, "CodeInitStdDev", 1.0)
        lat = torch.randn(self.num_scenes, self.latent_size, generator=gen) * (code_init_std / math.sqrt(self.latent_size))
        self.latents = lat.to(self.device).requires_grad_(True)
        groups = {"net": dict(self.decoder.named_parameters()), "lat": {"weight": self.latents}}
        self.gmm = None
        if self.use_gmm_prior:
            init = gmm_prior_init(gen, self.gmm_k, self.latent_size, self.gmm_init_sigma)
            self.gmm = groups["gmm"] = {k: v.to(self.device).requires_grad_(True) for k, v in init.items()}
        self.optimizer = GroupAdam(groups)

        # --- path ---
        precision = str(get_spec_with_default(specs, "MatmulPrecision", "default")).lower()
        reasons = []
        if not get_spec_with_default(specs, "UseFusedTrainKernel", True):
            reasons.append("UseFusedTrainKernel is false")
        if precision not in _BF16_PRECISIONS:
            reasons.append(f"MatmulPrecision {precision!r} is not bf16")
        if self.train_dropout or self.decoder.latent_dropout:
            reasons.append("dropout is active")
        if not supports_fused_train(self.decoder, self.num_samp_per_scene):
            reasons.append("supports_fused_train is false for this decoder and SamplesPerScene")
        if self.use_isometry:
            reasons.append("UseIsometryLoss is on")
        if self.use_grad_metric_iso:
            reasons.append("UseGradMetricIsotropyLoss is on")
        self.use_fused = not reasons
        if reasons:
            logging.info("Stage-1 step takes the autograd path: %s", "; ".join(reasons))
        if self.world_size > 1:
            logging.info("data-parallel over %d ranks; scene batch %d padded to %d", self.world_size,
                         self.scene_per_batch, pad_to_multiple(self.scene_per_batch, self.world_size))
        # K2's operand type: bf16 on the card; float32 for its plain version
        # on the CPU
        self.k2_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

        self.loss_log, self.loss_log_epoch, self.lr_log = [], [], []
        self.lat_mag_log, self.timing_log, self.param_mag_log = [], [], {}
        self.epoch = 0
        self.start_epoch = 1  # first epoch of this run; resume() moves it
        self.global_batch_idx = 0
        self._writer = None
        self._names = ckpt.msd_tpu_names(self.decoder)

    def _load_pretrained_decoder(self):
        """UsePretrainedSDFDecoder warm start (ref: train_deep_sdf.py:115-132)."""
        specs = self.specs
        pretrained_dir = get_spec_with_default(specs, "PretrainedSDFDecoderDir", None)
        if pretrained_dir is None:
            raise RuntimeError("UsePretrainedSDFDecoder=true but PretrainedSDFDecoderDir is not set.")
        name = get_spec_with_default(specs, "PretrainedSDFDecoderCheckpoint", "latest")
        if not os.path.isfile(os.path.join(pretrained_dir, ws.model_params_subdir, name + ".pth")):
            raise RuntimeError(f'pretrained model state dict "{name}" does not exist in {pretrained_dir}')
        epoch = ckpt.load_model(pretrained_dir, name, self.decoder)
        logging.info("Loaded pretrained SDF decoder from %s (checkpoint %s, epoch %s).", pretrained_dir, name, epoch)

    @property
    def writer(self):
        """TensorBoard writer, opened at first use (``open_summary_writer``)."""
        if self._writer is None:
            self._writer = open_summary_writer(ws.get_tensorboard_dir(self.experiment_directory))
        return self._writer

    # ------------------------------------------------------------------
    @property
    def world_size(self) -> int:
        return 1 if self.group is None else self.group.world_size

    @property
    def is_main(self) -> bool:
        """Rank 0, or the single-device trainer: the one that writes."""
        return self.group is None or self.group.is_main

    def _autograd_losses(self, lat_rows, xyz, gt, num_total, scene_weights=None):
        """Counterpart of ``point_losses`` (msd_tpu/train/stage1.py:399-482)
        for the clamped L1 and the eikonal term; float32 autograd. With
        EikonalNumPoints E < P the eikonal runs on the first E points of
        each scene and the other P - E run the forward only (:431-466).
        ``scene_weights`` [b] masks pad scenes out of both terms; the
        eikonal mean then runs over the real scenes. Over several ranks
        each rank takes its share of the scenes with the batch's
        normalizers; the caller sums the ranks' results."""
        b, P = xyz.shape[:2]
        eik_scenes = b if scene_weights is None else float(scene_weights.sum())
        if self.world_size > 1:
            rows = self.group.scene_slice(b)
            lat_rows, xyz, gt = lat_rows[rows], xyz[rows], gt[rows]
            scene_weights = None if scene_weights is None else scene_weights[rows]
            b = xyz.shape[0]
        c = self.clamp_dist
        E = self.eikonal_num_points
        E = 0 if not self.use_eikonal else (E if E is not None and 0 < E < P else P)

        def pred(x):  # clamped decoder at the scenes' latents, points x [b, n, 3] -> [b, n]
            n = x.shape[1]
            inputs = torch.cat([lat_rows.repeat_interleave(n, 0), x.reshape(-1, 3)], dim=1)
            return self.decoder(inputs).clamp(-c, c).reshape(b, n)

        x_e = xyz[:, :E].detach().requires_grad_(True) if E else None
        pred_e = pred(x_e) if E else None
        if E == P:
            p = pred_e
        elif E:
            p = torch.cat([pred_e, pred(xyz[:, E:])], dim=1)
        else:
            p = pred(xyz)
        err = (p - gt.clamp(-c, c)).abs()
        if scene_weights is not None:
            err = err * scene_weights[:, None]
        sdf = err.sum() / num_total
        eik = torch.zeros((), device=xyz.device)
        if E:
            (g,) = torch.autograd.grad(pred_e.sum(), x_e, create_graph=True)
            sq = (1.0 - safe_l2norm(g, dim=2)) ** 2
            if scene_weights is not None:
                sq = sq * scene_weights[:, None]
            eik = 0.002 * sq.sum() / (eik_scenes * E)
        return sdf + eik, sdf.detach(), eik.detach()

    def _isometry_losses(self, lat_rows, xyz, gt, gen, rng):
        """Isometry and grad-metric isotropy over one chunk's real scenes
        (``lat_rows`` [b, L], ``xyz`` [b, P, 3], ``gt`` [b, P]), the
        counterpart of msd_tpu/train/stage1.py:495-555: near-surface points,
        optional mixup of a scene's latent with another scene's, an optional
        random subset of the scenes; each term is its mean over the scenes
        times its lambda. Returns (the terms' sum, their metrics). The
        decoder runs without dropout, as there."""
        dev = lat_rows.device
        b, m = lat_rows.shape
        cap = self.iso_scenes_per_batch
        rows = rng.permutation(b)[:cap] if cap is not None and 0 < cap < b else np.arange(b)
        rows_t = torch.as_tensor(rows, device=dev)
        S, n = len(rows), self.iso_num_points
        noise = torch.rand(S, xyz.shape[1], generator=gen, device=dev)
        pts = select_near_surface_points(noise, xyz[rows_t], gt[rows_t], self.clamp_dist, n)
        lat = lat_rows[rows_t]
        if self.use_isometry_mixup and b > 1:
            # a partner among the other real scenes, a Beta(a, a) blend (:503-510)
            mix = torch.as_tensor(rng.random(S) < self.iso_mixup_prob, device=dev)
            partner = rng.integers(0, b - 1, S)
            partner = torch.as_tensor(partner + (partner >= rows), device=dev)
            alpha = torch.as_tensor(rng.beta(self.iso_mixup_alpha, self.iso_mixup_alpha, S), dtype=lat.dtype,
                                    device=dev)[:, None]
            lat = torch.where(mix[:, None], alpha * lat + (1 - alpha) * lat_rows[partner], lat)
        lat = lat[:, None, :].expand(S, n, m)
        total, out = lat.new_zeros(()), {}
        training = self.decoder.training
        self.decoder.eval()
        try:
            if self.use_isometry:
                probes = torch.randn(S, self.iso_num_probes, m, generator=gen, device=dev)
                loss, a = isometry_loss(self.decoder, lat, pts, m, probes)
                iso = loss.mean() * self.lambda_iso
                total = total + iso
                out.update(iso=iso.detach(), iso_g1=a["iso_g1"].mean(), iso_g2=a["iso_g2"].mean())
            if self.use_grad_metric_iso:
                loss, _ = grad_metric_isotropy_loss(self.decoder, lat, pts, m, self.grad_metric_iso_alpha,
                                                    self.grad_metric_iso_normalize)
                gmi = loss.mean() * self.grad_metric_iso_lambda
                total = total + gmi
                out["grad_metric_iso"] = gmi.detach()
        finally:
            self.decoder.train(training)
        return total, out

    def _latent_batch_losses(self, scene_idx):
        """Covariance and the GMM prior on the batch's latent rows, once per
        step (msd_tpu/train/stage1.py:555-574); returns (their sum, metrics)."""
        rows = self.latents[scene_idx]
        total, aux = rows.new_zeros(()), {}
        if self.use_covariance:
            cov = self.lambda_cov * covariance_loss(rows)
            total = total + cov
            aux["covariance"] = cov.detach()
        if self.use_gmm_prior:
            nll, gmm_aux = gmm_prior_loss(self.gmm, rows, min_sigma=self.gmm_min_sigma, learn_pi=self.gmm_learn_pi)
            gmm = self.gmm_lambda * nll
            total = total + gmm
            aux["gmm"] = gmm.detach()
            aux.update(gmm_aux)
        return total, aux

    def step(self, scene_idx, batch, epoch, lr_net, lr_lat, batch_split: int = 1, generator=None):
        """One training step on ``batch`` [4, B, P] (SoA: x, y, z, sdf) of
        the scenes ``scene_idx`` [B] (long); returns the step's metrics as
        device scalars. Counterpart of ``step`` in
        msd_tpu/train/stage1.py:576-685: ``batch_split`` chunks accumulate
        gradients, the clamped L1 keeps the full batch's normalizer and
        the chunks' eikonal means are summed. Over several ranks every rank
        passes the same batch; a chunk is padded to a multiple of the world
        size with scenes that alias scene 0 and carry weight 0.
        ``generator`` (on the trainer's device) gives the isometry terms'
        draws; None seeds one from (Seed, step)."""
        B, P = self.scene_per_batch, self.num_samp_per_scene
        num_total = B * P
        world = self.world_size
        bs = scene_idx.shape[0] // batch_split
        if batch_split > 1 and bs % world:
            raise NotImplementedError(
                f"batch_split > 1 with a scene batch padded for {world} ranks is unsupported; pick "
                "ScenesPerBatch / batch_split divisible by the rank count, or batch_split=1")
        if self.code_bound is not None:
            with torch.no_grad():
                self.latents[scene_idx] = project_code_bound(self.latents[scene_idx], self.code_bound)
        for group in self.optimizer.groups.values():
            for p in group.values():
                p.grad = None
        dev = self.latents.device
        iso = self.use_isometry or self.use_grad_metric_iso
        iso_keys = (("iso", "iso_g1", "iso_g2") if self.use_isometry else ()) + (
            ("grad_metric_iso",) if self.use_grad_metric_iso else ())
        aux = {k: torch.zeros((), device=dev) for k in ("sdf", "eikonal", "reg") + iso_keys}
        if iso:
            gen = generator or torch.Generator(device=dev).manual_seed(step_seed(self.seed, self.global_batch_idx))
            rng = np.random.default_rng([self.seed, self.global_batch_idx])
        # over ranks the autograd path sums its gradients after the chunks;
        # the code regulariser and the isometry terms, alike on every rank,
        # enter rank 0's only
        sum_after = world > 1 and not self.use_fused
        for i in range(batch_split):
            idx_c = scene_idx[i * bs:(i + 1) * bs]
            data_c = batch[:, i * bs:(i + 1) * bs]
            pad = pad_to_multiple(bs, world) - bs
            weights = None
            if pad:
                idx_c = torch.cat([idx_c, idx_c.new_zeros(pad)])
                data_c = torch.cat([data_c, data_c.new_zeros(4, pad, P)], dim=1)
                weights = (torch.arange(bs + pad, device=dev) < bs).float()
            lat_rows = self.latents[idx_c]
            xyz = data_c[:3].permute(1, 2, 0).contiguous()
            gt = data_c[3]
            if self.use_fused:
                total, sdf, eik = fused_sdf_loss(
                    self.decoder, lat_rows, xyz, gt, self.clamp_dist, self.use_eikonal, num_total,
                    dtype=self.k2_dtype, eik_points=self.eikonal_num_points, scene_weights=weights,
                    n_real=bs, group=self.group,
                )
            else:
                total, sdf, eik = self._autograd_losses(lat_rows, xyz, gt, num_total, weights)
            if self.do_code_regularization:
                # over the per-point rows (ref: train_deep_sdf.py:609-616):
                # P copies of each real scene's row
                reg = code_regularization(lat_rows[:bs], num_total / P, self.code_reg_lambda, epoch)
                aux["reg"] = aux["reg"] + reg.detach()
                if not sum_after or self.group.is_main:
                    total = total + reg
            if iso and (not sum_after or self.group.is_main):
                iso_total, iso_aux = self._isometry_losses(lat_rows[:bs], xyz[:bs], gt[:bs], gen, rng)
                total = total + iso_total
                for k, v in iso_aux.items():
                    aux[k] = aux[k] + v
            total.backward()
            aux["sdf"] = aux["sdf"] + sdf
            aux["eikonal"] = aux["eikonal"] + eik
        if sum_after:
            self.group.all_reduce_([p.grad for p in self.decoder.parameters()]
                                   + [self.latents.grad, aux["sdf"], aux["eikonal"]] + [aux[k] for k in iso_keys])
        if self.use_covariance or self.use_gmm_prior:
            # after the sum over ranks: every rank adds the same term once
            lb_total, lb_aux = self._latent_batch_losses(scene_idx)
            if lb_total.requires_grad:
                lb_total.backward()
            aux.update(lb_aux)
        lrs = {"net": lr_net, "lat": lr_lat, "gmm": lr_lat}
        norms = self.optimizer.step({g: lrs[g] for g in self.optimizer.groups}, max_norm=self.grad_clip)
        if "net" in norms:
            aux["net_grad_norm"] = norms["net"]
        aux["total"] = aux["sdf"] + aux["eikonal"] + aux["reg"]
        for k in ("iso", "grad_metric_iso", "covariance", "gmm"):
            if k in aux:
                aux["total"] = aux["total"] + aux[k]
        return aux

    def _param_norms(self):
        """{msd_tpu leaf name: device scalar} of the decoder's parameters."""
        params = dict(self.decoder.named_parameters())
        return {path: torch.linalg.vector_norm(params[name].detach()) for path, name, _ in self._names}

    def train_epoch(self, epoch: int, batch_split: int = 1, rng: np.random.Generator | None = None):
        """Run one epoch; returns its mean metrics (host floats), with the
        post-epoch mean latent magnitude and parameter norms (``pm_*``)
        fetched in the same transfer."""
        rng = rng or np.random.default_rng(epoch)
        lr_net = float(self.lr_schedules[0].get_learning_rate(epoch, self.loss_log_epoch))
        lr_lat = float(self.lr_schedules[1].get_learning_rate(epoch, self.loss_log_epoch))
        B = self.scene_per_batch
        nb = self.num_scenes // B
        if nb == 0:
            raise RuntimeError(f"ScenesPerBatch={B} > num_scenes={self.num_scenes}")
        perm = rng.permutation(self.num_scenes)
        dev = self.device
        idx_all = torch.as_tensor(perm[: nb * B].reshape(nb, B), device=dev)
        pos, pc, neg, nc = self.dataset.device_arrays(dev)
        steps = []
        for i in range(nb):
            self.global_batch_idx += 1
            gen = torch.Generator(device=dev).manual_seed(step_seed(self.seed, self.global_batch_idx))
            batch = sample_sdf_batch(pos, pc, neg, nc, idx_all[i], self.num_samp_per_scene, gen)
            steps.append(self.step(idx_all[i], batch, epoch, lr_net, lr_lat, batch_split, gen))
        keys = sorted(steps[0])
        extra = {"lat_mag_post": torch.linalg.vector_norm(self.latents.detach(), dim=1).mean()}
        extra.update({"pm_" + k: v for k, v in self._param_norms().items()})
        packed = torch.cat([
            torch.stack([torch.stack([s[k] for s in steps]) for k in keys]).reshape(-1),
            torch.stack(list(extra.values())),
        ]).cpu().numpy()
        per_step = packed[: len(keys) * nb].reshape(len(keys), nb)
        self.loss_log.extend(float(v) for v in per_step[keys.index("total")])
        mean = {k: float(np.mean(per_step[j])) for j, k in enumerate(keys)}
        mean.update({k: float(v) for k, v in zip(extra, packed[len(keys) * nb:])})
        self.loss_log_epoch.append(mean["total"])
        self.lr_log.append([lr_net, lr_lat])
        return mean

    # ------------------------------------------------------------------
    def train(self, start_epoch: int = 1, num_epochs: int | None = None, batch_split: int = 1, eval_hooks=True):
        num_epochs = num_epochs or self.num_epochs
        eval_train_frequency = get_spec_with_default(self.specs, "EvalTrainFrequency", 300)
        eval_test_frequency = get_spec_with_default(self.specs, "EvalTestFrequency", 500)
        rng = np.random.default_rng(self.seed + start_epoch)
        profile_epochs = set(get_spec_with_default(self.specs, "ProfileEpochs", []) or [])
        for epoch in range(start_epoch, num_epochs + 1):
            t0 = time.time()
            self.epoch = epoch
            with self._epoch_profiler() if epoch in profile_epochs else contextlib.nullcontext():
                mean = self.train_epoch(epoch, batch_split, rng)
            self._post_epoch(epoch, mean, time.time() - t0, self.lr_log[-1], eval_hooks,
                             eval_train_frequency, eval_test_frequency)
        self.save_checkpoint("latest")
        self.save_logs()

    def _epoch_profiler(self):
        """A ``torch.profiler.profile`` whose trace goes to
        ``<exp>/TensorBoard/profile`` as ``rank<r>.<ns>.pt.trace.json``;
        CUDA activity too on the card, where a trace without any raises."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        on_card = self.device.type == "cuda"
        rank = self.group.rank if self.group is not None else 0
        write = tensorboard_trace_handler(os.path.join(self.experiment_directory, ws.tb_logs_dir, "profile"),
                                          worker_name=f"rank{rank}")

        def on_trace_ready(prof):
            if on_card and not any(e.device_type == DeviceType.CUDA for e in prof.key_averages()):
                raise RuntimeError("ProfileEpochs: the profiler recorded no CUDA activity; no trace written")
            write(prof)

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        return profile(activities=activities, on_trace_ready=on_trace_ready)

    def _post_epoch(self, epoch, mean, seconds, lr_pair, eval_hooks, eval_train_frequency, eval_test_frequency):
        """Per-epoch bookkeeping: logs, TensorBoard scalars, checkpoints, eval
        hooks (ref: train_deep_sdf.py:834-956)."""
        self.timing_log.append(seconds)
        self.lat_mag_log.append(mean["lat_mag_post"])
        mags = {k[3:]: v for k, v in mean.items() if k.startswith("pm_")}
        for name, mag in mags.items():
            self.param_mag_log.setdefault(name, []).append(mag)
        logging.info("epoch %d loss=%.6f sdf=%.6f time=%.2fs", epoch, mean["total"], mean["sdf"], seconds)
        if not self.is_main:
            return
        w = self.writer
        w.add_scalar("Loss/train", mean["total"], epoch)
        w.add_scalar("Loss/train_sdf", mean["sdf"], epoch)
        w.add_scalar("Loss/train_reg", mean["reg"], epoch)
        if self.use_eikonal:
            w.add_scalar("Loss/train_eikonal", mean["eikonal"], epoch)
        if self.use_covariance:
            w.add_scalar("Loss/train_covariance", mean["covariance"], epoch)
        if self.use_gmm_prior:
            w.add_scalar("Loss/train_gmm", mean["gmm"], epoch)
            w.add_scalar("Loss/train_gmm_nll", mean["gmm_nll"], epoch)
            w.add_scalar("Loss/train_gmm_entropy", mean["gmm_entropy"], epoch)
        if self.use_isometry:
            w.add_scalar("Loss/train_isometry", mean["iso"], epoch)
            w.add_scalar("Loss/train_isometry_G1", mean["iso_g1"], epoch)
            w.add_scalar("Loss/train_isometry_G2", mean["iso_g2"], epoch)
        if self.use_grad_metric_iso:
            w.add_scalar("Loss/train_grad_metric_iso", mean["grad_metric_iso"], epoch)
        w.add_scalar("Learning Rate/Params", lr_pair[0], epoch)
        w.add_scalar("Learning Rate/Latent", lr_pair[1], epoch)
        w.add_scalar("Mean Latent Magnitude/train", mean["lat_mag_post"], epoch)
        w.add_scalar("Time/epoch (min)", seconds / 60, epoch)
        for name, mag in mags.items():
            w.add_scalar(f"WeightsNorm/{name}", mag, epoch)
        if "net_grad_norm" in mean:
            w.add_scalar("GradsNorm/allNetParams.grad", mean["net_grad_norm"], epoch)

        if epoch in self.checkpoints:
            self.save_checkpoint(str(epoch))
        if epoch % self.log_frequency == 0:
            self.save_checkpoint("latest")
            self.save_logs()
        if eval_hooks:
            if eval_train_frequency and epoch % eval_train_frequency == 0:
                self._eval_train(epoch)
            if eval_test_frequency and epoch % eval_test_frequency == 0:
                self._eval_test(epoch)
        w.flush()

    # ------------------------------------------------------------------
    def save_checkpoint(self, name: str):
        if not self.is_main:
            return
        ckpt.save_model(self.experiment_directory, name + ".pth", self.decoder, self.epoch)
        ckpt.save_optimizer(self.experiment_directory, name + ".pth", self.decoder, self.optimizer, self.epoch)
        ckpt.save_latent_vectors(self.experiment_directory, name + ".pth", self.latents, self.epoch)

    def save_logs(self):
        if not self.is_main:
            return
        ckpt.save_logs(self.experiment_directory, self.loss_log, self.lr_log, self.timing_log,
                       self.lat_mag_log, self.param_mag_log, self.epoch)

    def resume(self, continue_from: str) -> int:
        """Load model, optimizer, latents and logs; returns the start epoch
        (ref: train_deep_sdf.py:467-505)."""
        lat, lat_epoch = ckpt.load_latent_vectors(
            self.experiment_directory, continue_from + ".pth",
            expected_shape=(self.num_scenes, self.latent_size),
        )
        with torch.no_grad():
            self.latents.copy_(lat)
        model_epoch = ckpt.load_model(self.experiment_directory, continue_from, self.decoder)
        optimizer_epoch = ckpt.load_optimizer(self.experiment_directory, continue_from + ".pth",
                                              self.decoder, self.optimizer)
        try:
            (self.loss_log, self.lr_log, self.timing_log, self.lat_mag_log, self.param_mag_log,
             log_epoch) = ckpt.load_logs(self.experiment_directory)
            if log_epoch != model_epoch:
                (self.loss_log, self.lr_log, self.timing_log, self.lat_mag_log,
                 self.param_mag_log) = ckpt.clip_logs(
                    self.loss_log, self.lr_log, self.timing_log, self.lat_mag_log,
                    self.param_mag_log, model_epoch,
                )
            self.loss_log_epoch = [
                float(np.mean(chunk)) for chunk in np.array_split(self.loss_log, max(1, len(self.lr_log)))
            ] if self.loss_log else []
        except Exception:
            logging.warning("no Logs.pth found; continuing without log history")
        if not (model_epoch == optimizer_epoch and model_epoch == lat_epoch):
            raise RuntimeError(f"epoch mismatch: {model_epoch} vs {optimizer_epoch} vs {lat_epoch}")
        for i, sched in enumerate(self.lr_schedules):
            if isinstance(sched, StepLearningRateOnPlateauSchedule) and self.lr_log:
                sched.set_state(self.lr_log[-1][i])
        self.epoch = model_epoch
        # the point draws continue where an unbroken run would be
        self.global_batch_idx = model_epoch * (self.num_scenes // self.scene_per_batch)
        self.start_epoch = model_epoch + 1
        return self.start_epoch

    # ------------------------------------------------------------------
    # Eval hooks (train-set mesh Chamfer / test-set reconstruction) through
    # the port's create_mesh and reconstruct_batch (ref: train_deep_sdf.py
    # :934-1032). Their figures import plotting (so matplotlib) inside the
    # hook and are skipped with a warning when that fails, as msd_tpu's
    # (msd_tpu/train/stage1.py:1252-1264, :1329-1337).
    def _eval_train(self, epoch):
        torus_path = get_spec_with_default(self.specs, "TorusPath", None)
        if not torus_path or not os.path.exists(str(torus_path)):
            return
        from msd_tpu_torch import mesh as mesh_mod
        from msd_tpu_torch.data.mesh_io import load_mesh
        from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer

        eval_grid_res = get_spec_with_default(self.specs, "EvalGridResolution", 256)
        n_eval = min(get_spec_with_default(self.specs, "EvalTrainSceneNumber", 10), self.num_scenes)
        dists, all_dists, compare_rows = [], [], []
        self.decoder.eval()
        try:
            for index in range(n_eval):
                save_name = os.path.basename(self.dataset.npyfiles[index]).split(".npz")[0]
                out_dir = os.path.join(self.experiment_directory, ws.tb_logs_dir,
                                       ws.tb_logs_train_reconstructions, save_name)
                os.makedirs(out_dir, exist_ok=True)
                tri = mesh_mod.create_mesh(self.decoder, self.latents[index].detach(),
                                           filename=os.path.join(out_dir, f"epoch={epoch}"),
                                           N=eval_grid_res, return_mesh=True)
                gt_path = os.path.join(str(torus_path), save_name + ".obj")
                if tri is not False and os.path.exists(gt_path):
                    cd, per_point = compute_mesh_chamfer(gt_path, tri)
                    dists.append(cd)
                    all_dists.append(np.asarray(per_point))
                    if len(compare_rows) < 3:
                        compare_rows.append((save_name, [load_mesh(gt_path), tri]))
        finally:
            self.decoder.train()
        if dists:
            self.writer.add_scalar("Mean Chamfer Dist/train", float(np.mean(dists)), epoch)
            # CD-percentile violin + GT-vs-reconstruction comparison figures
            # (ref: train_deep_sdf.py:947-954 add_figure pattern)
            try:
                from msd_tpu_torch import plotting

                fig, _ = plotting.plot_dist_violin(np.concatenate(all_dists))
                self.writer.add_figure("CD Percentiles/train dists", fig, global_step=epoch)
                if compare_rows:
                    fig = plotting.plot_mesh_comparison(compare_rows)
                    self.writer.add_figure("Reconstructions/train comparison", fig, global_step=epoch)
            except Exception as exc:
                logging.warning("eval figures skipped: %s", exc)

    def _eval_test(self, epoch):
        """Test-set eval: fit a latent per test shape from its SDF samples,
        mesh it, and Chamfer against the GT mesh (ref: train_deep_sdf.py:958-1032)."""
        specs = self.specs
        torus_path = get_spec_with_default(specs, "TorusPath", None)
        test_split_file = get_spec_with_default(specs, "TestSplit", None)
        if not test_split_file or not os.path.exists(str(test_split_file)):
            return
        from msd_tpu_torch import mesh as mesh_mod
        from msd_tpu_torch.data.sdf_samples import read_sdf_samples, remove_nans
        from msd_tpu_torch.data.splits import get_instance_filenames
        from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer
        from msd_tpu_torch.train.reconstruct import reconstruct_batch

        filenames = get_instance_filenames(self.data_source, load_split(test_split_file))
        n_eval = min(get_spec_with_default(specs, "EvalTestSceneNumber", 10), len(filenames))
        steps = get_spec_with_default(specs, "EvalTestOptimizationSteps", 1000)
        eval_grid_res = get_spec_with_default(specs, "EvalGridResolution", 256)
        t0 = time.time()
        names, shapes = [], []
        for fname in filenames[:n_eval]:
            if not os.path.isfile(fname):
                continue
            pos, neg = read_sdf_samples(fname)
            shapes.append((remove_nans(pos), remove_nans(neg)))
            names.append(os.path.basename(fname).split(".npz")[0])
        if not shapes:
            return
        errs, latents = reconstruct_batch(self.decoder, int(steps), self.latent_size, shapes, 0.01, 0.1,
                                          num_samples=16384, lr=5e-3, l2reg=True)
        dists, lat_mags, all_dists = [], [], []
        self.decoder.eval()
        try:
            for save_name, latent in zip(names, latents):
                lat_mags.append(float(torch.linalg.vector_norm(latent)))
                out_dir = os.path.join(self.experiment_directory, ws.tb_logs_dir,
                                       ws.tb_logs_test_reconstructions, save_name)
                os.makedirs(out_dir, exist_ok=True)
                tri = mesh_mod.create_mesh(self.decoder, latent, filename=os.path.join(out_dir, f"epoch={epoch}"),
                                           N=eval_grid_res, return_mesh=True)
                gt_path = os.path.join(str(torus_path), save_name + ".obj") if torus_path else None
                if tri is not False and gt_path and os.path.exists(gt_path):
                    cd, per_point = compute_mesh_chamfer(gt_path, tri)
                    dists.append(cd)
                    all_dists.append(np.asarray(per_point))
        finally:
            self.decoder.train()
        self.writer.add_scalar("Loss/test", float(np.mean(errs)), epoch)
        self.writer.add_scalar("Mean Latent Magnitude/test", float(np.mean(lat_mags)), epoch)
        if dists:
            self.writer.add_scalar("Mean Chamfer Dist/test", float(np.mean(dists)), epoch)
            # CD-percentile violin figure (ref: train_deep_sdf.py:1026-1027)
            try:
                from msd_tpu_torch import plotting

                fig, _ = plotting.plot_dist_violin(np.concatenate(all_dists))
                self.writer.add_figure("CD Percentiles/test dists", fig, global_step=epoch)
            except Exception as exc:
                logging.warning("test eval figures skipped: %s", exc)
        self.writer.add_scalar("Time/test eval per shape (sec)", (time.time() - t0) / max(1, n_eval), epoch)
        return {"names": names, "errors": [float(e) for e in errs], "chamfer": dists}


def main_function(experiment_directory: str, continue_from=None, batch_split: int = 1, device="cuda"):
    trainer = Stage1Trainer(experiment_directory, device=device)
    start_epoch = 1
    if continue_from is not None:
        logging.info('continuing from "%s"', continue_from)
        start_epoch = trainer.resume(continue_from)
    logging.info("starting from epoch %d", start_epoch)
    logging.info("Number of decoder parameters: %d", sum(p.numel() for p in trainer.decoder.parameters()))
    logging.info("Number of shape code parameters: %d (# codes %d, code dim %d)",
                 trainer.num_scenes * trainer.latent_size, trainer.num_scenes, trainer.latent_size)
    try:
        trainer.train(start_epoch=start_epoch, batch_split=batch_split)
    except KeyboardInterrupt:
        logging.error("Received KeyboardInterrupt. Cleaning up and ending training.")
    finally:
        if trainer.epoch > 0:
            trainer.save_checkpoint("latest")
            trainer.save_logs()
        if trainer._writer is not None:
            scalar_keys = ("CodeLength", "NumEpochs", "SamplesPerScene", "ScenesPerBatch",
                           "ClampingDistance", "CodeRegularizationLambda")
            hparams = {k: trainer.specs[k] for k in scalar_keys if k in trainer.specs}
            final = trainer.loss_log_epoch[-1] if trainer.loss_log_epoch else float("nan")
            try:
                trainer.writer.add_hparams(hparams, {"final_loss": final})
            except Exception as exc:  # the writer's own hparams summary is best effort, as in msd_tpu
                logging.warning("hparams summary skipped: %s", exc)
            trainer.writer.close()
    return trainer
