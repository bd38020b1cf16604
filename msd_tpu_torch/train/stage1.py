"""Stage-1 DeepSDF auto-decoder trainer (counterpart of
``msd_tpu/train/stage1.py``, single device).

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
off.

Differences from ``msd_tpu`` (documented): the random streams (torch
generators, not JAX keys), so runs of the two packages draw different
points from the same seed; the scene batches come from the same numpy
generator and agree. Epoch blocks (``train/epoch_blocks.py``) were a relay
workaround and are not ported. Covariance, GMM prior, isometry,
grad-metric isotropy and ``EikonalNumPoints`` raise as not ported yet.
"""

from __future__ import annotations

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
from msd_tpu_torch.losses.sdf import clamped_l1_sum, code_regularization, eikonal_loss
from msd_tpu_torch.lr_schedules import StepLearningRateOnPlateauSchedule, get_learning_rate_schedules
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.ops.fused_train import fused_sdf_loss, supports_fused_train
from msd_tpu_torch.utils import checkpoint as ckpt
from msd_tpu_torch.utils.logging_utils import open_summary_writer
from msd_tpu_torch.utils.optim import GroupAdam, project_code_bound

# MatmulPrecision spec values that keep the bf16 products K2 computes in
# (msd_tpu/train/stage1.py:64-70); every other value runs float32 autograd.
_BF16_PRECISIONS = ("default", "bfloat16")

# Stage-1 spec switches of msd_tpu that the port does not run yet.
_NOT_PORTED = {
    "UseCovarianceLoss": "covariance loss (ROADMAP M9)",
    "UseGMMPriorLoss": "GMM prior (ROADMAP M9)",
    "UseIsometryLoss": "isometry loss (ROADMAP M9)",
    "UseGradMetricIsotropyLoss": "grad-metric isotropy loss (ROADMAP M9)",
}


def step_seed(seed: int, step: int) -> int:
    """Seed of the point draw of global step ``step``: a resumed run draws
    what an unbroken run would."""
    return (int(seed) * 1_000_003 + int(step)) % (2**63)


class Stage1Trainer:
    def __init__(self, experiment_directory: str, specs: dict | None = None,
                 dataset: SdfDataset | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.experiment_directory = experiment_directory
        self.specs = specs if specs is not None else ws.load_experiment_specifications(experiment_directory)
        specs = self.specs
        validate_stage1_specs(specs)
        note_noop_keys(specs)
        logging.info("Experiment description: \n%s", specs.get("Description", "(none)"))
        for key, what in _NOT_PORTED.items():
            if get_spec_with_default(specs, key, False):
                raise NotImplementedError(f"{key}: {what} is not ported to msd_tpu_torch yet")
        if get_spec_with_default(specs, "EikonalNumPoints", None):
            raise NotImplementedError(
                "EikonalNumPoints: K2 variant c (tile-gated eikonal) is not ported yet (ROADMAP B.1)"
            )
        if get_spec_with_default(specs, "ProfileEpochs", None):
            logging.info("ProfileEpochs: profiling is not ported to msd_tpu_torch yet; ignored")

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
        self.seed = get_spec_with_default(specs, "Seed", 0)
        self.lr_schedules = get_learning_rate_schedules(specs)

        # --- decoder and latents ---
        gen = torch.Generator().manual_seed(self.seed)
        self.decoder = build_decoder(specs["NetworkArch"], self.latent_size, specs["NetworkSpecs"], generator=gen)
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
        self.optimizer = GroupAdam({"net": dict(self.decoder.named_parameters()), "lat": {"weight": self.latents}})

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
        self.use_fused = not reasons
        if reasons:
            logging.info("Stage-1 step takes the autograd path: %s", "; ".join(reasons))
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
    def _autograd_losses(self, lat_rows, xyz, gt, num_total):
        """Counterpart of ``point_losses`` (msd_tpu/train/stage1.py:399-482)
        for the clamped L1 and the eikonal term; float32 autograd."""
        b, P = xyz.shape[:2]
        c = self.clamp_dist
        x = xyz.reshape(-1, 3)
        if self.use_eikonal:
            x = x.detach().requires_grad_(True)
        pred = self.decoder(torch.cat([lat_rows.repeat_interleave(P, 0), x], dim=1)).clamp(-c, c)
        eik = torch.zeros((), device=xyz.device)
        if self.use_eikonal:
            (g,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
            eik = eikonal_loss(g)
        sdf = clamped_l1_sum(pred, gt.reshape(-1, 1), c, num_total)
        return sdf + eik, sdf.detach(), eik.detach()

    def step(self, scene_idx, batch, epoch, lr_net, lr_lat, batch_split: int = 1):
        """One training step on ``batch`` [4, B, P] (SoA: x, y, z, sdf) of
        the scenes ``scene_idx`` [B] (long); returns the step's metrics as
        device scalars. Counterpart of ``step`` in
        msd_tpu/train/stage1.py:576-685: ``batch_split`` chunks accumulate
        gradients, the clamped L1 keeps the full batch's normalizer and
        the chunks' eikonal means are summed."""
        B, P = self.scene_per_batch, self.num_samp_per_scene
        num_total = B * P
        if self.code_bound is not None:
            with torch.no_grad():
                self.latents[scene_idx] = project_code_bound(self.latents[scene_idx], self.code_bound)
        for group in self.optimizer.groups.values():
            for p in group.values():
                p.grad = None
        dev = self.latents.device
        aux = {k: torch.zeros((), device=dev) for k in ("sdf", "eikonal", "reg")}
        bs = scene_idx.shape[0] // batch_split
        for i in range(batch_split):
            idx_c = scene_idx[i * bs:(i + 1) * bs]
            data_c = batch[:, i * bs:(i + 1) * bs]
            lat_rows = self.latents[idx_c]
            xyz = data_c[:3].permute(1, 2, 0).contiguous()
            gt = data_c[3]
            if self.use_fused:
                total, sdf, eik = fused_sdf_loss(
                    self.decoder, lat_rows, xyz, gt, self.clamp_dist, self.use_eikonal, num_total,
                    dtype=self.k2_dtype,
                )
            else:
                total, sdf, eik = self._autograd_losses(lat_rows, xyz, gt, num_total)
            if self.do_code_regularization:
                # over the per-point rows (ref: train_deep_sdf.py:609-616):
                # P copies of each scene's row
                reg = code_regularization(lat_rows, num_total / P, self.code_reg_lambda, epoch)
                total = total + reg
                aux["reg"] = aux["reg"] + reg.detach()
            total.backward()
            aux["sdf"] = aux["sdf"] + sdf
            aux["eikonal"] = aux["eikonal"] + eik
        norms = self.optimizer.step({"net": lr_net, "lat": lr_lat}, max_norm=self.grad_clip)
        if "net" in norms:
            aux["net_grad_norm"] = norms["net"]
        aux["total"] = aux["sdf"] + aux["eikonal"] + aux["reg"]
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
            steps.append(self.step(idx_all[i], batch, epoch, lr_net, lr_lat, batch_split))
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
        for epoch in range(start_epoch, num_epochs + 1):
            t0 = time.time()
            self.epoch = epoch
            mean = self.train_epoch(epoch, batch_split, rng)
            self._post_epoch(epoch, mean, time.time() - t0, self.lr_log[-1], eval_hooks,
                             eval_train_frequency, eval_test_frequency)
        self.save_checkpoint("latest")
        self.save_logs()

    def _post_epoch(self, epoch, mean, seconds, lr_pair, eval_hooks, eval_train_frequency, eval_test_frequency):
        """Per-epoch bookkeeping: logs, TensorBoard scalars, checkpoints, eval
        hooks (ref: train_deep_sdf.py:834-956)."""
        self.timing_log.append(seconds)
        self.lat_mag_log.append(mean["lat_mag_post"])
        mags = {k[3:]: v for k, v in mean.items() if k.startswith("pm_")}
        for name, mag in mags.items():
            self.param_mag_log.setdefault(name, []).append(mag)
        logging.info("epoch %d loss=%.6f sdf=%.6f time=%.2fs", epoch, mean["total"], mean["sdf"], seconds)
        w = self.writer
        w.add_scalar("Loss/train", mean["total"], epoch)
        w.add_scalar("Loss/train_sdf", mean["sdf"], epoch)
        w.add_scalar("Loss/train_reg", mean["reg"], epoch)
        if self.use_eikonal:
            w.add_scalar("Loss/train_eikonal", mean["eikonal"], epoch)
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
        ckpt.save_model(self.experiment_directory, name + ".pth", self.decoder, self.epoch)
        ckpt.save_optimizer(self.experiment_directory, name + ".pth", self.decoder, self.optimizer, self.epoch)
        ckpt.save_latent_vectors(self.experiment_directory, name + ".pth", self.latents, self.epoch)

    def save_logs(self):
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
    # :934-1032). The figures need plotting, not ported yet (ROADMAP M12).
    def _eval_train(self, epoch):
        torus_path = get_spec_with_default(self.specs, "TorusPath", None)
        if not torus_path or not os.path.exists(str(torus_path)):
            return
        from msd_tpu_torch import mesh as mesh_mod
        from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer

        eval_grid_res = get_spec_with_default(self.specs, "EvalGridResolution", 256)
        n_eval = min(get_spec_with_default(self.specs, "EvalTrainSceneNumber", 10), self.num_scenes)
        dists = []
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
                    dists.append(compute_mesh_chamfer(gt_path, tri)[0])
        finally:
            self.decoder.train()
        if dists:
            self.writer.add_scalar("Mean Chamfer Dist/train", float(np.mean(dists)), epoch)
            logging.warning("eval figures skipped: plotting is not ported to msd_tpu_torch yet (ROADMAP M12)")

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
        dists, lat_mags = [], []
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
                    dists.append(compute_mesh_chamfer(gt_path, tri)[0])
        finally:
            self.decoder.train()
        self.writer.add_scalar("Loss/test", float(np.mean(errs)), epoch)
        self.writer.add_scalar("Mean Latent Magnitude/test", float(np.mean(lat_mags)), epoch)
        if dists:
            self.writer.add_scalar("Mean Chamfer Dist/test", float(np.mean(dists)), epoch)
            logging.warning("test eval figures skipped: plotting is not ported to msd_tpu_torch yet (ROADMAP M12)")
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
