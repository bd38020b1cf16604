"""Stage-2 disentanglement-VAE trainer (counterpart of
``msd_tpu/train/stage2.py``), on one device or data-parallel over ranks.

One step: the VAE over the batch's Stage-1 latents (the residual MLP-VAE)
or over its shapes' surface point clouds (``PointNetLatentVAE``, a point
``EncoderType``), the chosen
VAE objective (beta-VAE, DIP-VAE, beta-TCVAE), every enabled
disentanglement loss on mu (SNNL cls/reg/age, attribute, leakage, cross
covariance, rank, match-std, sensitivity, DIP-VAE-II covariance), and the
SDF-consistency term of z_hat through the Stage-1 decoder, then one
gradient, per-group clipping and Adam (ref: train_MLP_VAE_deep_sdf.py
:2770-3150).

Path choice for the SDF-consistency term, as ``msd_tpu/train/stage2.py
:532-553``: K2 (``ops/fused_train.fused_sdf_l1``; its CUDA kernels on a
GPU, bf16) when ``UseFusedSDFKernel`` is not false, ``batch_split`` is 1
and ``supports_fused_train`` holds. With ``TrainSDFDecoder`` false (the
flagship configs) that is variant d, the frozen decoder's loss and latent
gradient only; with it true, variant a. On the CPU K2's plain version runs
in float32. Otherwise the float32 autograd path runs over ``batch_split``
chunks of the point axis (mean of chunk means), each chunk's backward taken
before the next so that memory holds one chunk's graph.

Differences from ``msd_tpu`` (documented): the random streams. ``step``
takes the point batch [4, B, P] and the two noise tensors (the VAE's
reparameterisation and the covariance penalty's) as arguments and draws
them from a torch generator seeded from (Seed, step) when they are not
given; the scene batches and label mixing come from the same numpy
generator as ``msd_tpu`` and agree. PointNet++'s FPS start indices are a
``step`` argument too, drawn from the same generator when not given;
``compute_vae_latents`` draws them from a generator seeded 0 per chunk,
where ``msd_tpu`` uses ``PRNGKey(0)``. Epoch blocks were a relay workaround
and are not ported.

Points mode (``EncoderType`` resnet_pointnet/pointnet, pointnet2/pointnet++
or pointnet_encoder; msd_tpu/train/stage2.py:143-171, :296-309): the
training set carries ``SurfacePointCount`` surface points per shape from
``DataSourceMesh``, the VAE encodes the batch's clouds and still
reconstructs the teacher latents. The encoders' BatchNorm running
statistics are buffers, outside Adam: the step's one training-mode VAE
forward folds its batch into them, which equals ``msd_tpu``'s overwrite
after Adam (it keeps zero-gradient moments for them); eval mode
(``compute_vae_latents``, the eval blocks) leaves them, and the
sensitivity loss decodes only. As ``msd_tpu`` cannot, the port does not
checkpoint a point-encoder VAE: ``save_checkpoint`` and
``PretrainedVAEPath`` raise, so ``train()`` stops at its first snapshot.

Data-parallel (``group=``, a ``parallel.DataParallelGroup``; the
counterpart of ``Stage2Trainer(mesh=)``,
msd_tpu/train/stage2.py:424-442, :512-553): the VAE (in points mode its
decoder) and every batch-statistic loss run on every rank, on the same
inputs and noise. When ScenesPerBatch is a multiple of the world size,
the batch splits over the ranks by scenes: the SDF-consistency term
through K2, its latent gradient and loss summed over them, and in points
mode the point encoder, each rank encoding its scenes' clouds with
BatchNorm statistics over every rank's rows (as XLA takes ``msd_tpu``'s
over the global batch) and mu and logvar gathered back; the FPS starts
and the noise are drawn for the whole batch on every rank, in one
process's order. The encoder's gradients are then each rank's share and
are summed over the ranks before clipping and Adam; the decoder's are
whole on every rank. Otherwise every rank runs the whole batch (the
point encoder with no collective, as ``msd_tpu`` replicates an
indivisible batch), and on the autograd path every rank computes the
whole SDF term. Every rank's update is then the single-device update.
Eval-mode forwards use the running statistics and take no collective.
Only rank 0 writes checkpoints, logs and TensorBoard and runs the eval
blocks; every rank resumes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.config import get_spec_with_default, note_noop_keys, resolve_spec_path
from msd_tpu_torch.data.labels import labels_for_instances, load_labels
from msd_tpu_torch.data.sdf_samples import SdfDataset, sample_sdf_batch
from msd_tpu_torch.data.splits import load_split
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.losses import disentangle as dl
from msd_tpu_torch.losses import vae as vl
from msd_tpu_torch.losses.sdf import deep_sdf_loss, safe_l2norm
from msd_tpu_torch.lr_schedules import StepLearningRateOnPlateauSchedule, get_learning_rate_schedules
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.pointnet_vae import PointNetLatentVAE
from msd_tpu_torch.models.residual_mlp_vae import ResidualMLPVAE
from msd_tpu_torch.ops.fused_train import fused_sdf_l1, supports_fused_train
from msd_tpu_torch.parallel.mesh_utils import all_reduce_sum
from msd_tpu_torch.train.stage1 import step_seed
from msd_tpu_torch.utils import checkpoint as ckpt
from msd_tpu_torch.utils.logging_utils import open_summary_writer
from msd_tpu_torch.utils.optim import GroupAdam

_LATENT_ENCODERS = ("residual_mlp", "mlp", "latent", "latent_mlp")
_CLASSIFICATION = ("classification", "class", "cls", "binary")
_NO_POINT_CHECKPOINT = ("cannot checkpoint a point-encoder VAE, as msd_tpu cannot (PointNetLatentVAE has no "
                        "torch state-dict conversion, msd_tpu/models/pointnet_vae.py)")
_DIP_OBJECTIVES = {"dip_vae", "dip_vae_ii", "dip_vae2", "dip_ii", "dip2", "dip_vae_i", "dip_vae1", "dip_i", "dip1"}


def load_teacher_latents(path: str) -> np.ndarray:
    """Stage-1 latent codes as [S, L] float32: an Embedding state dict, a
    raw tensor, or an id -> vector dict (ref: train_MLP_VAE_deep_sdf.py
    :299-321)."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    codes = data["latent_codes"] if isinstance(data, dict) and "latent_codes" in data else data
    if isinstance(codes, dict) and "weight" in codes:
        arr = codes["weight"].detach().numpy()
    elif hasattr(codes, "detach"):
        arr = codes.detach().numpy()
        if arr.ndim == 3:
            arr = arr[:, 0, :]
    elif isinstance(codes, dict):
        arr = np.stack([np.asarray(v) for v in codes.values()])
    else:
        arr = np.asarray(codes)
    return np.asarray(arr, np.float32)


def sum_grads_over(group, params):
    """Sum the parameters' gradients over ``group``'s ranks in place, in
    their dtype, in one collective."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, total in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(total.view_as(g))


@contextlib.contextmanager
def eval_mode(*modules):
    """Eval mode (no dropout) and no autograd for the duration."""
    was = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        for m, w in zip(modules, was):
            m.train(w)


class Stage2Trainer:
    def __init__(self, experiment_directory: str, specs: dict | None = None, dataset: SdfDataset | None = None,
                 teacher_latents: np.ndarray | None = None, device="cuda", group=None):
        """``group``: a ``parallel.DataParallelGroup`` to train
        data-parallel over its ranks (on its device); None trains on
        ``device`` alone."""
        self.group = group
        self.is_main = group is None or group.is_main
        self.device = resolve_device(group.device if group is not None else device)
        self.experiment_directory = experiment_directory
        self.specs = specs if specs is not None else ws.load_experiment_specifications(experiment_directory)
        note_noop_keys(self.specs)
        specs = self.specs
        logging.info("Experiment description: \n%s", specs.get("Description", "(none)"))
        g = lambda k, d: get_spec_with_default(specs, k, d)  # noqa: E731

        self.num_samp_per_scene = specs["SamplesPerScene"]
        self.scene_per_batch = specs["ScenesPerBatch"]
        self.clamp_dist = specs["ClampingDistance"]
        self.num_epochs = specs["NumEpochs"]
        self.grad_clip = g("GradientClipNorm", None)
        self.snapshot_frequency = specs["SnapshotFrequency"]
        self.additional_snapshots = g("AdditionalSnapshots", [])
        self.checkpoints = sorted(
            list(range(self.snapshot_frequency, self.num_epochs + 1, self.snapshot_frequency))
            + list(self.additional_snapshots)
        )
        self.log_frequency = g("LogFrequency", 100)
        self.seed = g("Seed", 0)

        # ---- teacher latents (ref: :672-689) ----
        if teacher_latents is None:
            path = resolve_spec_path(g("PretrainedLatentPath", None) or g("LatentCodesPath", None),
                                     experiment_directory)
            if path is None:
                raise Exception("PretrainedLatentPath or LatentCodesPath must be set in specs")
            teacher_latents = load_teacher_latents(path)
        self.teacher_latents = np.asarray(teacher_latents, np.float32)
        latent_dim = self.teacher_latents.shape[1]
        code_length = g("CodeLength", latent_dim)
        if code_length != latent_dim:
            raise Exception(
                f"CodeLength does not match pretrained latent dimensionality: {code_length} vs {latent_dim}"
            )
        self.latent_size = code_length

        # ---- SDF decoder (ref: :691-702) ----
        gen = torch.Generator().manual_seed(self.seed)
        self.sdf_decoder = build_decoder(specs["NetworkArch"], self.latent_size, specs["NetworkSpecs"], generator=gen)
        self.train_sdf_decoder = bool(g("TrainSDFDecoder", False))
        self.use_fused_sdf = bool(g("UseFusedSDFKernel", True))
        sdf_path = resolve_spec_path(g("PretrainedSDFDecoderPath", None) or g("PretrainedDecoderPath", None),
                                     experiment_directory)
        if sdf_path is not None:
            data = torch.load(sdf_path, map_location="cpu", weights_only=False)
            self.sdf_decoder.load_state_dict(data.get("model_state_dict", data) if isinstance(data, dict) else data)
            logging.info("Loaded pretrained SDF decoder from: %s", sdf_path)
        self.sdf_decoder = self.sdf_decoder.to(self.device).train()
        for p in self.sdf_decoder.parameters():
            p.requires_grad_(self.train_sdf_decoder)

        # ---- VAE (ref: :897-932) ----
        self.vae_input_dim = g("VAEInputDim", self.latent_size)
        if self.vae_input_dim != self.latent_size:
            raise Exception("VAEInputDim must match pretrained latent size")
        self.vae_latent_dim = g("VAELatentDim", 16)
        self.use_kl = bool(g("UseKLLoss", True))
        self.encoder_type = str(g("EncoderType", "residual_mlp")).lower()
        if self.encoder_type in _LATENT_ENCODERS:
            self.vae_input_mode = "latent"
            self.vae = ResidualMLPVAE(
                input_dim=self.vae_input_dim, latent_dim=self.vae_latent_dim,
                encoder_hidden_dims=g("VAEEncoderHiddenDims", [256, 128]),
                decoder_hidden_dims=g("VAEDecoderHiddenDims", [128, 256, 256]),
                num_blocks=g("VAEBlocks", 1), activation=g("VAEActivation", "gelu"), dropout=g("VAEDropout", 0.0),
                use_layernorm=g("VAELayerNorm", True), use_kl=self.use_kl, generator=gen,
            )
        else:
            self.vae_input_mode = "points"
            self.vae = PointNetLatentVAE(
                latent_dim=self.vae_latent_dim, output_dim=self.vae_input_dim, encoder_type=self.encoder_type,
                decoder_hidden_dims=g("VAEDecoderHiddenDims", [128, 256, 256]), decoder_blocks=g("VAEBlocks", 1),
                decoder_activation=g("VAEActivation", "gelu"), decoder_dropout=g("VAEDropout", 0.0),
                decoder_layernorm=g("VAELayerNorm", True), use_kl=self.use_kl, generator=gen,
            )
        vae_path = resolve_spec_path(g("PretrainedVAEPath", None), experiment_directory)
        if vae_path and self.vae_input_mode == "points":
            raise NotImplementedError(f"PretrainedVAEPath: {_NO_POINT_CHECKPOINT}")
        if vae_path:
            data = torch.load(vae_path, map_location="cpu", weights_only=False)
            self.vae.load_state_dict(data.get("vae_state_dict", data) if isinstance(data, dict) else data)
            logging.info("Loading pretrained VAE from: %s", vae_path)
        self.vae = self.vae.to(self.device).train()

        # ---- objective and loss switches (ref: :707-895) ----
        self.vae_objective = str(g("VAEObjective", "beta_vae")).lower()
        self.recon_loss_type = g("VAEReconLoss", "mse")
        self.vae_recon_weight = g("VAEReconWeight", 1.0)
        self.vae_kl_weight = g("VAEKLWeight", 1.0)
        self.vae_kl_warmup_epochs = g("KLWarmupEpochs", 0)
        self.sdf_loss_weight = g("SDFLossWeight", 1.0)
        self.do_code_regularization = g("CodeRegularization", True)
        self.code_reg_lambda = g("CodeRegularizationLambda", 1e-4)
        self.code_reg_warmup_epochs = g("CodeRegularizationWarmupEpochs", 100)
        self.beta_tc = (g("BetaTC_Alpha", 1.0), g("BetaTC_Beta", 6.0), g("BetaTC_Gamma", 1.0))
        self.beta_tc_dataset_size = g("BetaTC_DatasetSize", None)
        dip_type = str(g("DIPVAEType", "ii")).lower()
        self.use_dip_objective = self.vae_objective in _DIP_OBJECTIVES
        if self.vae_objective in ("dip_vae_ii", "dip_vae2", "dip_ii", "dip2"):
            dip_type = "ii"
        elif self.vae_objective in ("dip_vae_i", "dip_vae1", "dip_i", "dip1"):
            dip_type = "i"
        self.dip_vae_type = dip_type
        self.dip_vae_lambda_od = g("DIPVAE_LambdaOD", 1.0)
        self.dip_vae_lambda_d = g("DIPVAE_LambdaD", 1.0)

        self.guided_contrastive_loss = g("GuidedContrastiveLoss", False)
        self.attribute_loss = g("AttributeLoss", False)
        label_task_type = g("LabelTaskType", None)
        self.label_task_type = str(label_task_type).lower() if label_task_type is not None else None
        if "SNNLType" in specs:
            self.snnl_type = str(specs["SNNLType"]).lower()
        elif self.label_task_type in _CLASSIFICATION:
            self.snnl_type = "cls"
        else:
            self.snnl_type = "reg_exact"
        self.snnl_temp = g("SNNLTemp", 181.0)
        self.snnl_weight = g("SNNLWeight", 0.5)
        self.attr_weight = g("AttributeWeight", 0.5)
        self.covariance_loss = g("CovarianceLoss", False)
        self.covariance_lambda = g("CovarianceLossLambda", 1.0)
        self.label_index = g("LabelIndex", 0)
        self.attribute_latent_index = g("AttributeLatentIndex", 0)
        self.snnl_target_dim = g("SNNLTargetDim", 0)
        self.snnl_reg_threshold = g("SNNLRegThreshold", 0.05)
        self.snnl_reg_pos_mode = g("SNNLRegPosMode", "threshold")
        self.snnl_reg_topk_frac = g("SNNLRegTopkFrac", 0.1)
        self.snnl_reg_use_adaptive_T = g("SNNLRegUseAdaptiveT", True)
        self.snnl_reg_normalize_z = g("SNNLRegNormalizeZ", True)
        self.age_snnl_reg_loss = g("AgeSNNLRegLoss", False)
        self.age_snnl_reg_weight = g("AgeSNNLRegWeight", 0.5)
        self.age_snnl_reg_label_index = g("AgeSNNLRegLabelIndex", 1)
        self.age_snnl_reg_target_dim = g("AgeSNNLRegTargetDim", 1)
        self.age_snnl_reg_temp = g("AgeSNNLRegTemp", self.snnl_temp)
        self.age_snnl_reg_threshold = g("AgeSNNLRegThreshold", self.snnl_reg_threshold)
        self.age_snnl_reg_pos_mode = g("AgeSNNLRegPosMode", self.snnl_reg_pos_mode)
        self.age_snnl_reg_topk_frac = g("AgeSNNLRegTopkFrac", self.snnl_reg_topk_frac)
        self.age_snnl_reg_use_adaptive_T = g("AgeSNNLRegUseAdaptiveT", self.snnl_reg_use_adaptive_T)
        self.age_snnl_reg_normalize_z = g("AgeSNNLRegNormalizeZ", self.snnl_reg_normalize_z)
        self.corr_leakage_loss = g("CorrLeakageLoss", False)
        self.corr_leakage_lambda = g("CorrLeakageLambda", 1.0)
        self.age_corr_leakage_loss = g("AgeCorrLeakageLoss", False)
        self.age_corr_leakage_lambda = g("AgeCorrLeakageLambda", self.corr_leakage_lambda)
        self.cross_cov_loss = g("CrossCovLoss", False)
        self.cross_cov_lambda = g("CrossCovLambda", 1.0)
        self.sensitivity_loss = g("SensitivityLoss", False)
        self.sensitivity_eps = g("SensitivityEps", 0.02)
        self.sensitivity_eta = g("SensitivityEta", 0.0025)
        self.sensitivity_weight = g("SensitivityWeight", 0.1)
        self.sensitivity_target_dim = g("SensitivityLatentIndex", 0)
        self.rank_loss = g("RankLoss", False)
        self.rank_margin = g("RankLossMargin", 0.5)
        self.rank_weight = g("RankLossWeight", 0.1)
        self.rank_target_dim = g("RankLossTargetDim", 0)
        self.rank_cn_label = g("RankLossCNLabel", 1)
        self.matchstd_loss = g("MatchStdLoss", False)
        self.matchstd_weight = g("MatchStdWeight", 0.1)
        self.matchstd_target_dim = g("MatchStdTargetDim", 0)
        self.matchstd_eps = g("MatchStdEps", 1e-6)
        self.leakage_target_dim = g("LeakageTargetDim", self.attribute_latent_index)
        self.age_leakage_target_dim = g("AgeLeakageTargetDim", self.age_snnl_reg_target_dim)

        # label mixing (ref: :817-833, :2905-3004)
        self.label_mix_enabled = g("LabelMixing", False)
        self.pseudo_labels_file = g("PseudoLabelsFile", "pseudo_label.pt")
        self.real_labels_file = g("RealLabelsFile", "labels.pt")
        self.mix_pseudo_start = float(g("LabelMixPseudoRatioStart", 1.0))
        self.mix_unlabeled_start = float(g("LabelMixUnlabeledRatioStart", 0.0))
        self.label_mix_stratified = g("LabelMixStratified", False)
        if (self.mix_pseudo_start < 0 or self.mix_unlabeled_start < 0
                or 1.0 - self.mix_pseudo_start - self.mix_unlabeled_start < 0):
            raise RuntimeError("Invalid label mix ratios")

        self.use_labels = g("ReturnLabels", None)
        if self.use_labels is None:
            self.use_labels = (
                self.guided_contrastive_loss or self.attribute_loss or self.corr_leakage_loss
                or self.age_corr_leakage_loss or self.rank_loss or self.age_snnl_reg_loss
                or g("ComputeSAP", False) or g("ComputeSAPAge", False)
            )
        self.labels_filename = g("LabelsFile", "labels.pt")
        self.compute_sap = g("ComputeSAP", False)
        self.compute_sap_age = g("ComputeSAPAge", False)
        self.holdout_frac = float(g("TrainLatentHoldoutFraction", 0.0))
        self.holdout_seed = g("TrainLatentHoldoutSeed", 0)

        # ---- data ----
        self.data_source = specs["DataSource"]
        self._labels_map = None
        if self.use_labels and not (dataset is not None and dataset.labels is not None):
            self._labels_map = load_labels(os.path.join(self.data_source, self.labels_filename))
        if dataset is None:
            dataset = SdfDataset.from_split(
                self.data_source, load_split(specs["TrainSplit"]), self.num_samp_per_scene,
                labels=self._labels_map, warn_missing_labels=g("WarnMissingLabels", True),
                data_source_mesh=g("DataSourceMesh", None),
                return_surface_points=self.vae_input_mode == "points" and g("ReturnSurfacePoints", True),
                surface_point_count=g("SurfacePointCount", 2048),
            )
        self.dataset = dataset
        if self.vae_input_mode == "points" and dataset.surface_points is None:
            raise RuntimeError("Surface points required for point-based encoder.")
        self.val_split_file = g("ValSplit", None)
        self.test_split_file = g("TestSplit", None)
        self._eval_datasets = {}
        self.num_scenes = dataset.num_scenes
        if self.teacher_latents.shape[0] != self.num_scenes:
            raise Exception(
                f"num teacher latents ({self.teacher_latents.shape[0]}) != num scenes ({self.num_scenes})"
            )
        self.pseudo_label_arr = None
        self.real_label_arr = None
        if self.label_mix_enabled:
            self.pseudo_label_arr = labels_for_instances(
                load_labels(os.path.join(self.data_source, self.pseudo_labels_file)), dataset.instance_ids)
            self.real_label_arr = labels_for_instances(
                load_labels(os.path.join(self.data_source, self.real_labels_file)), dataset.instance_ids)

        # metric-label maps (SAPCORRLabelsFile / SAPAgeCORRLabelsFile, ref: :857-866, :1204-1217)
        self.sap_corr_labels_file = g("SAPCORRLabelsFile", "labels.pt")
        self.sap_age_corr_labels_file = g("SAPAgeCORRLabelsFile", self.sap_corr_labels_file)
        self._sap_corr_label_map = None
        self._sap_age_label_map = None
        self._metric_label_cache = {}
        if self.compute_sap or int(g("SAPCORRExtraFrequency", 0) or 0) > 0 or self.compute_sap_age:
            self._sap_corr_label_map = self._load_metric_label_map(self.sap_corr_labels_file)
        if self.compute_sap_age:
            if self.sap_age_corr_labels_file == self.sap_corr_labels_file:
                self._sap_age_label_map = self._sap_corr_label_map
            else:
                self._sap_age_label_map = self._load_metric_label_map(self.sap_age_corr_labels_file)

        # train-latent holdout (ref: :1014-1035)
        perm = np.random.default_rng(self.holdout_seed).permutation(self.num_scenes)
        n_holdout = int(round(self.holdout_frac * self.num_scenes))
        self.holdout_indices = np.sort(perm[:n_holdout])
        self.train_indices = np.sort(perm[n_holdout:])

        # ---- optimizer (ref: :1400-1409): groups "vae" and, when the decoder trains, "sdf" ----
        self.lr_schedules = get_learning_rate_schedules(specs)
        groups = {"vae": dict(self.vae.named_parameters())}
        if self.train_sdf_decoder:
            groups["sdf"] = dict(self.sdf_decoder.named_parameters())
        self.optimizer = GroupAdam(groups)

        # ---- SDF-consistency path ----
        reasons = []
        if not self.use_fused_sdf:
            reasons.append("UseFusedSDFKernel is false")
        if not supports_fused_train(self.sdf_decoder, self.num_samp_per_scene):
            reasons.append("supports_fused_train is false for this decoder and SamplesPerScene")
        self.fused_ok = not reasons
        if reasons:
            logging.info("Stage-2 SDF term takes the autograd path: %s", "; ".join(reasons))
        self.k2_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

        self.loss_log = []
        self.loss_log_epoch = []
        self.logs_history = {k: [] for k in list(self._LOG_FAMILIES) + ["learning_rate", "timing"]}
        self.epoch = 0
        self.start_epoch = 1
        self.global_batch_idx = 0
        self._writer = None
        self._teacher_dev = None
        self._surface_dev = None
        self._last_kl_weight = 0.0
        self._last_code_reg_weight = 0.0
        self.last_train_sap = None
        self.last_holdout_sap = None
        self.last_eval_metrics = None

    # ------------------------------------------------------------------
    def _load_metric_label_map(self, fname):
        """Raw id -> vector map for metric labels (ref: :491-520): None
        filename -> metrics skipped; the training LabelsFile reuses its map;
        a missing file falls back to dataset-attached labels, else raises."""
        if fname is None:
            return None
        if fname == self.labels_filename and self._labels_map is not None:
            return self._labels_map
        path = fname if os.path.isabs(fname) else os.path.join(self.data_source, fname)
        if not os.path.isfile(path):
            if self.dataset.labels is not None:
                logging.info("metric labels file %s not found; using dataset-attached labels", path)
                return None
            raise FileNotFoundError(f"labels file not found: {path}")
        return load_labels(path)

    def metric_label_matrix(self, dataset=None, age: bool = False):
        """[num_scenes, L] label matrix for SAP/corr metrics on ``dataset``
        (default: the train dataset); None -> metrics skipped."""
        ds = dataset if dataset is not None else self.dataset
        label_map = self._sap_age_label_map if age else self._sap_corr_label_map
        if label_map is None:
            if (self.sap_age_corr_labels_file if age else self.sap_corr_labels_file) is None:
                logging.warning("Metrics skipped: SAPCORRLabelsFile is missing.")
                return None
            return ds.labels
        key = (id(ds), bool(age))
        if key not in self._metric_label_cache:
            self._metric_label_cache[key] = labels_for_instances(label_map, ds.instance_ids, warn_missing=False)
        return self._metric_label_cache[key]

    @property
    def writer(self):
        """TensorBoard writer, opened at first use (``open_summary_writer``)."""
        if self._writer is None:
            self._writer = open_summary_writer(ws.get_tensorboard_dir(self.experiment_directory))
        return self._writer

    # ------------------------------------------------------------------
    def _vae_objective(self, z_hat, teacher, z, mu, logvar, kl_weight):
        if self.vae_objective in ("beta_tcvae", "beta_tc", "tcvae"):
            total, recon, kl, _, _, _ = vl.beta_tcvae_loss(
                z_hat, teacher, z, mu, logvar, recon_weight=self.vae_recon_weight, kl_weight=kl_weight,
                tc_alpha=self.beta_tc[0], tc_beta=self.beta_tc[1], tc_gamma=self.beta_tc[2],
                recon_loss=self.recon_loss_type, dataset_size=self.beta_tc_dataset_size,
            )
            return total, recon, kl, torch.zeros_like(total)
        if self.use_dip_objective:
            total, recon, kl, dip, _, _ = vl.dip_vae_loss(
                z_hat, teacher, mu, logvar, recon_weight=self.vae_recon_weight, kl_weight=kl_weight,
                dip_lambda_od=self.dip_vae_lambda_od, dip_lambda_d=self.dip_vae_lambda_d,
                dip_type=self.dip_vae_type, recon_loss=self.recon_loss_type,
            )
            return total, recon, kl, dip
        total, recon, kl = vl.vae_loss(z_hat, teacher, mu, logvar, recon_weight=self.vae_recon_weight,
                                       kl_weight=kl_weight, recon_loss=self.recon_loss_type)
        return total, recon, kl, torch.zeros_like(total)

    def _snnl(self, mu, label_values, valid):
        if self.snnl_type in ("reg", "reg_fast", "regloss"):
            return dl.snn_reg_loss(mu, label_values, self.snnl_temp, self.snnl_reg_threshold, valid=valid)
        if self.snnl_type in ("cls", "class", "classification"):
            return dl.snn_loss_cls(mu, label_values, T=self.snnl_temp, target_dim=self.snnl_target_dim, valid=valid)
        return dl.snn_reg_loss_exact(
            mu, label_values, T=self.snnl_temp, target_dim=self.snnl_target_dim,
            threshold=self.snnl_reg_threshold, pos_mode=self.snnl_reg_pos_mode,
            topk_frac=self.snnl_reg_topk_frac, use_adaptive_T=self.snnl_reg_use_adaptive_T,
            normalize_z=self.snnl_reg_normalize_z, valid=valid,
        )

    def _vae_losses(self, mu, logvar, z, z_hat, teacher, labels, kl_weight, cov_noise):
        """The VAE objective plus every enabled label/latent loss on mu
        (ref: :3007-3076); returns (vae_total, aux)."""
        label_values, label_valid, age_values, age_valid = labels
        total, recon, kl, dip = self._vae_objective(z_hat, teacher, z, mu, logvar, kl_weight)
        aux = {"vae_recon": recon, "vae_kl": kl, "dip": dip,
               "vae_lat_mag": torch.linalg.vector_norm(mu, dim=1).mean().detach()}

        def add(key, weight, value):
            nonlocal total
            total = total + weight * value
            aux[key] = value

        if self.guided_contrastive_loss:
            add("snnl", self.snnl_weight, self._snnl(mu, label_values, label_valid))
        if self.attribute_loss:
            add("attr", self.attr_weight,
                dl.attribute_loss(mu[:, self.attribute_latent_index], label_values, valid=label_valid))
        if self.corr_leakage_loss:
            add("corr_leak", self.corr_leakage_lambda,
                dl.corr_leakage_penalty(mu, label_values, self.leakage_target_dim, valid=label_valid))
        if self.cross_cov_loss:
            add("cross_cov", self.cross_cov_lambda, dl.cross_cov_penalty(mu, self.leakage_target_dim, valid=label_valid))
        if self.rank_loss:
            add("rank", self.rank_weight, dl.rank_loss_z0(
                mu, label_values, margin=self.rank_margin, target_dim=self.rank_target_dim,
                cn_label=self.rank_cn_label, valid=label_valid))
        if self.age_snnl_reg_loss:
            add("snnl_age", self.age_snnl_reg_weight, dl.snn_reg_loss_exact(
                mu, age_values, T=self.age_snnl_reg_temp, target_dim=self.age_snnl_reg_target_dim,
                threshold=self.age_snnl_reg_threshold, pos_mode=self.age_snnl_reg_pos_mode,
                topk_frac=self.age_snnl_reg_topk_frac, use_adaptive_T=self.age_snnl_reg_use_adaptive_T,
                normalize_z=self.age_snnl_reg_normalize_z, valid=age_valid))
        if self.age_corr_leakage_loss:
            add("age_corr_leak", self.age_corr_leakage_lambda,
                dl.corr_leakage_penalty(mu, age_values, self.age_leakage_target_dim, valid=age_valid))
        if self.matchstd_loss:
            ms, std0, stdref = dl.match_std_z0(mu, self.matchstd_target_dim, self.matchstd_eps)
            add("matchstd", self.matchstd_weight, ms)
            aux["matchstd_std0"], aux["matchstd_stdref"] = std0, stdref
        if self.sensitivity_loss:
            sens, delta = dl.sensitivity_loss(mu, self.vae.decode, eps=self.sensitivity_eps,
                                              eta=self.sensitivity_eta, target_dim=self.sensitivity_target_dim)
            add("sens", self.sensitivity_weight, sens)
            aux["sens_delta"] = delta
        if self.covariance_loss:
            add("cov", 1.0, vl.dip_vae_ii_loss(cov_noise, mu, logvar, beta=self.covariance_lambda))
        return total, aux

    def step(self, scene_idx, labels, kl_weight, code_reg_weight, lr_vae, lr_sdf, batch_split: int = 1,
             batch=None, noise=None, cov_noise=None, fps_start=None, generator=None):
        """One training step on the scenes ``scene_idx`` [B] (long) with
        ``labels`` = (label_values, label_valid, age_values, age_valid) [B]
        from ``_batch_labels``; returns the step's metrics as device
        scalars. Counterpart of ``loss_fn`` + ``step`` in
        msd_tpu/train/stage2.py:555-721.

        ``batch`` [4, B, P] (SoA: x, y, z, sdf), ``noise`` [B, D] (the
        reparameterisation's) and ``cov_noise`` [B, D] (the covariance
        penalty's) are drawn from ``generator`` when not given, and so are
        PointNet++'s FPS starts ``fps_start`` ((start1 [B], start2 [B]))."""
        dev = self.device
        B, P = scene_idx.shape[0], self.num_samp_per_scene
        if batch_split > 1 and (B * P) % batch_split != 0:
            raise ValueError(f"batch_split={batch_split} must divide ScenesPerBatch*SamplesPerScene={B * P}")
        if batch is None:
            pos, pc, neg, nc = self.dataset.device_arrays(dev)
            batch = sample_sdf_batch(pos, pc, neg, nc, scene_idx, P, generator)
        D = self.vae_latent_dim
        if noise is None and self.use_kl:
            noise = torch.randn(B, D, generator=generator, device=dev)
        if cov_noise is None and self.covariance_loss:
            cov_noise = torch.randn(B, D, generator=generator, device=dev)
        labels = tuple(torch.as_tensor(np.asarray(a), device=dev) for a in labels)
        for group in self.optimizer.groups.values():
            for p in group.values():
                p.grad = None

        if self._teacher_dev is None:
            self._teacher_dev = torch.as_tensor(self.teacher_latents, device=dev)
        teacher = self._teacher_dev[scene_idx]
        # over ranks, split by scenes where the batch divides (:424-442, :538-541)
        split = self.group is not None and B % self.group.world_size == 0
        if self.vae_input_mode == "points":  # the clouds stay on the device, as the teacher latents
            if self._surface_dev is None:
                self._surface_dev = torch.as_tensor(self.dataset.surface_points, dtype=torch.float32, device=dev)
            out = self.vae(self._surface_dev[scene_idx], noise=noise, fps_start=fps_start, generator=generator,
                           group=self.group if split else None)
        else:
            out = self.vae(teacher, noise=noise)
        mu, logvar, z, z_hat = out["mu"], out["logvar"], out["z"], out["z_hat"]
        vae_total, aux = self._vae_losses(mu, logvar, z, z_hat, teacher, labels, kl_weight, cov_noise)

        # SDF-consistency through the Stage-1 decoder (ref: :3097-3138)
        xyz = batch[:3].permute(1, 2, 0).contiguous()
        gt = batch[3].clamp(-self.clamp_dist, self.clamp_dist)
        reg_w = code_reg_weight if self.do_code_regularization else 0.0
        w = self.sdf_loss_weight
        if self.fused_ok and batch_split == 1:
            sdf_l = fused_sdf_l1(self.sdf_decoder, z_hat, xyz, gt, self.clamp_dist,
                                 train_net=self.train_sdf_decoder, dtype=self.k2_dtype,
                                 group=self.group if split else None)
            # the per-point code regulariser over the expanded latents is
            # the scene-level lam * w * sum_scenes ||z_hat|| / B
            sdf_reg = self.code_reg_lambda * reg_w * safe_l2norm(z_hat, dim=1).sum() / B
            total = vae_total + w * (sdf_l + sdf_reg)
            total.backward()
        else:
            # chunks of the point axis, each chunk's backward taken at once
            # into a detached z_hat, then one backward of the VAE's graph
            zd = z_hat.detach().requires_grad_(True)
            xyz_flat = xyz.reshape(-1, 3)
            gt_flat = gt.reshape(-1, 1)
            n = B * P // batch_split
            sdf_l = torch.zeros((), device=dev)
            sdf_reg = torch.zeros((), device=dev)
            for i in range(batch_split):
                rows = torch.arange(i * n, (i + 1) * n, device=dev)
                lp = zd[rows // P]  # the chunk's per-point latent rows
                pred = self.sdf_decoder(torch.cat([lp, xyz_flat[rows]], dim=1))
                pred = pred.clamp(-self.clamp_dist, self.clamp_dist)
                t, l1, r = deep_sdf_loss(pred, gt_flat[rows], lp, code_reg_lambda=self.code_reg_lambda,
                                         code_reg_weight=reg_w)
                (w * t / batch_split).backward()
                sdf_l = sdf_l + l1.detach() / batch_split
                sdf_reg = sdf_reg + r.detach() / batch_split
            total = vae_total + w * (sdf_l + sdf_reg)
            dz = zd.grad if zd.grad is not None else torch.zeros_like(z_hat)
            torch.autograd.backward([vae_total, z_hat], [torch.ones_like(vae_total), dz])
        if split and self.vae_input_mode == "points":
            # each rank's encoder saw its scenes: its gradients are shares
            sum_grads_over(self.group, self.vae.encoder.parameters())
        aux["sdf"] = sdf_l.detach()
        aux["sdf_reg"] = sdf_reg.detach()
        aux["vae_total"] = vae_total.detach()
        aux["total"] = total.detach()
        aux = {k: v.detach() for k, v in aux.items()}

        lrs = {"vae": lr_vae, "sdf": lr_sdf}
        self.optimizer.step(lrs, max_norm=self.grad_clip,
                            clip_groups=("vae", "sdf") if self.train_sdf_decoder else ("vae",))
        return aux

    # ------------------------------------------------------------------
    def _batch_labels(self, scene_idx: np.ndarray, rng: np.random.Generator):
        """Host-side label selection including label mixing (ref: :2905-3004);
        returns (label_values [B], valid [B], age_values [B], age_valid [B])."""
        b = len(scene_idx)
        nanv = np.full((b,), np.nan, np.float32)
        label_values = nanv.copy()
        if self.label_mix_enabled:
            pseudo_ratio = self.mix_pseudo_start
            real_ratio = 1.0 - pseudo_ratio - self.mix_unlabeled_start
            if self.label_mix_stratified:
                k_real = int(round(real_ratio * b))
                k_pseudo = int(round(pseudo_ratio * b))
                if k_real + k_pseudo > b:
                    k_pseudo = max(0, b - k_real)
                perm = rng.permutation(b)
                real_mask = np.zeros(b, bool)
                pseudo_mask = np.zeros(b, bool)
                real_mask[perm[:k_real]] = True
                pseudo_mask[perm[k_real:k_real + k_pseudo]] = True
            else:
                rand = rng.random(b)
                real_mask = rand < real_ratio
                pseudo_mask = (rand >= real_ratio) & (rand < real_ratio + pseudo_ratio)
            if pseudo_mask.any():
                label_values[pseudo_mask] = self.pseudo_label_arr[scene_idx][pseudo_mask, self.label_index]
            if real_mask.any():
                label_values[real_mask] = self.real_label_arr[scene_idx][real_mask, self.label_index]
        elif self.use_labels and self.dataset.labels is not None:
            label_values = self.dataset.labels[scene_idx, self.label_index].astype(np.float32)
        valid = np.isfinite(label_values) & (label_values != -1)
        age_values = nanv.copy()
        age_valid = np.zeros(b, bool)
        if (self.age_snnl_reg_loss or self.age_corr_leakage_loss) and self.dataset.labels is not None:
            age_values = self.dataset.labels[scene_idx, self.age_snnl_reg_label_index].astype(np.float32)
            age_valid = np.isfinite(age_values) & (age_values != -1)
        return np.nan_to_num(label_values), valid, np.nan_to_num(age_values), age_valid

    def epoch_weights(self, epoch: int):
        """(lr_vae, lr_sdf, kl_weight, code_reg_weight) of ``epoch``
        (msd_tpu/train/stage2.py:829-844)."""
        lr_vae = float(self.lr_schedules[0].get_learning_rate(epoch, self.loss_log_epoch))
        sdf_sched = self.lr_schedules[1] if len(self.lr_schedules) > 1 else self.lr_schedules[0]
        lr_sdf = float(sdf_sched.get_learning_rate(epoch, self.loss_log_epoch))
        kl_weight = self.vae_kl_weight * vl.linear_warmup(epoch, self.vae_kl_warmup_epochs) if self.use_kl else 0.0
        if self.do_code_regularization:
            crw = 1.0 if self.code_reg_warmup_epochs <= 0 else min(1.0, epoch / float(self.code_reg_warmup_epochs))
        else:
            crw = 0.0
        return lr_vae, lr_sdf, kl_weight, crw

    def train_epoch(self, epoch: int, batch_split: int = 1, rng: np.random.Generator | None = None):
        """One epoch over the non-holdout scenes; returns its mean metrics
        (host floats), fetched from the device once."""
        rng = rng or np.random.default_rng(epoch)
        lr_vae, lr_sdf, kl_weight, crw = self.epoch_weights(epoch)
        self._last_kl_weight, self._last_code_reg_weight, self._last_lr_vae = kl_weight, crw, lr_vae
        train_idx = self.train_indices
        perm = rng.permutation(len(train_idx))
        nb = len(train_idx) // self.scene_per_batch
        if nb == 0:
            raise RuntimeError("ScenesPerBatch larger than (non-holdout) train set")
        steps = []
        for bidx in range(nb):
            sel = train_idx[perm[bidx * self.scene_per_batch:(bidx + 1) * self.scene_per_batch]]
            labels = self._batch_labels(sel, rng)
            self.global_batch_idx += 1
            gen = torch.Generator(device=self.device).manual_seed(step_seed(self.seed, self.global_batch_idx))
            steps.append(self.step(torch.as_tensor(sel, device=self.device), labels, kl_weight, crw, lr_vae,
                                   lr_sdf, batch_split, generator=gen))
        keys = sorted(steps[0])
        packed = torch.stack([torch.stack([s[k].float() for s in steps]) for k in keys]).cpu().numpy()
        self.loss_log.extend(float(v) for v in packed[keys.index("total")])
        mean = {k: float(np.mean(packed[j])) for j, k in enumerate(keys)}
        self.loss_log_epoch.append(mean["total"])
        return mean

    def train(self, start_epoch: int = 1, num_epochs: int | None = None, batch_split: int = 1):
        num_epochs = num_epochs or self.num_epochs
        rng = np.random.default_rng(self.seed + start_epoch)
        plateau = any(isinstance(s, StepLearningRateOnPlateauSchedule) for s in self.lr_schedules)
        for epoch in range(start_epoch, num_epochs + 1):
            t0 = time.time()
            self.epoch = epoch
            mean = self.train_epoch(epoch, batch_split, rng)
            # a plateau schedule is stateful: keep the LR the epoch used
            self._post_epoch(epoch, mean, time.time() - t0, self._last_lr_vae if plateau else None)
        self.save_checkpoint("latest")
        self.save_logs()

    def _post_epoch(self, epoch, mean, seconds, lr_vae=None):
        """Per-epoch bookkeeping: logs, TensorBoard scalars, checkpoints and
        eval blocks (ref: train_MLP_VAE_deep_sdf.py:3319-3913)."""
        from msd_tpu_torch.train import stage2_eval as ev

        self.epoch = epoch
        if lr_vae is None:
            lr_vae = float(self.lr_schedules[0].get_learning_rate(epoch, self.loss_log_epoch))
        for log_key, metric_key in self._LOG_FAMILIES.items():
            if metric_key in mean:
                self.logs_history[log_key].append(float(mean[metric_key]))
        self.logs_history["learning_rate"].append(lr_vae)
        self.logs_history["timing"].append(seconds)
        logging.info("epoch %d total=%.6f vae_recon=%.6f sdf=%.6f time=%.2fs",
                     epoch, mean["total"], mean["vae_recon"], mean["sdf"], seconds)
        if not self.is_main:
            return
        w = self.writer
        w.add_scalar("Loss/train", mean["total"], epoch)
        w.add_scalar("Loss/train_sdf", mean["sdf"], epoch)
        w.add_scalar("Loss/train_sdf_reg", mean["sdf_reg"], epoch)
        w.add_scalar("Loss/vae_recon", mean["vae_recon"], epoch)
        w.add_scalar("Loss/vae_kl", mean["vae_kl"], epoch)
        w.add_scalar("Mean Latent Magnitude/vae_mu", mean["vae_lat_mag"], epoch)
        for k in ("snnl", "snnl_age", "attr", "cov", "corr_leak", "age_corr_leak", "cross_cov", "rank",
                  "matchstd", "sens", "dip"):
            if k in mean:
                w.add_scalar(f"Loss/{k}", mean[k], epoch)
        if epoch in self.checkpoints:
            self.save_checkpoint(str(epoch))
        if epoch % self.log_frequency == 0:
            self.save_checkpoint("latest")
            self.save_logs()
        ev.run_evals(self, epoch)
        w.flush()

    # ------------------------------------------------------------------
    def compute_vae_latents(self, inputs=None, batch_size: int = 1024) -> np.ndarray:
        """The VAE's mu for every scene (the train latents, in points mode
        the surface clouds, or ``inputs``), exported to LatentCodes (ref:
        :1638-1659). In eval mode; a point encoder's FPS starts come from a
        generator seeded 0 for each chunk."""
        points = self.vae_input_mode == "points"
        if inputs is None:
            inputs = self.dataset.surface_points if points else self.teacher_latents
        x = torch.as_tensor(np.asarray(inputs, np.float32), device=self.device)

        def encode(chunk):
            if points:
                return self.vae.encode(chunk, generator=torch.Generator(device=self.device).manual_seed(0))[0]
            return self.vae.encoder(chunk)[0]

        with eval_mode(self.vae):
            mu = [encode(x[s:s + batch_size]) for s in range(0, x.shape[0], batch_size)]
        return torch.cat(mu).cpu().numpy()

    def save_checkpoint(self, name: str):
        if self.vae_input_mode == "points":
            raise NotImplementedError(_NO_POINT_CHECKPOINT)
        if not self.is_main:
            return
        ckpt.save_stage2_model(self.experiment_directory, name + ".pth", self.vae, self.sdf_decoder, self.epoch)
        ckpt.save_stage2_optimizer(self.experiment_directory, name + ".pth", self.vae,
                                   self.sdf_decoder if self.train_sdf_decoder else None, self.optimizer, self.epoch)
        ckpt.save_latent_vectors(self.experiment_directory, name + ".pth",
                                 torch.from_numpy(self.compute_vae_latents()), self.epoch)

    # reference Logs.pth key -> train_epoch metric key (msd_tpu/train/stage2.py:1077-1097)
    _LOG_FAMILIES = {
        "loss_epoch": "total",
        "sdf_loss_epoch": "sdf",
        "sdf_reg_epoch": "sdf_reg",
        "vae_recon_epoch": "vae_recon",
        "vae_kl_epoch": "vae_kl",
        "vae_latent_magnitude": "vae_lat_mag",
        "snnl_epoch": "snnl",
        "snnl_age_epoch": "snnl_age",
        "attr_epoch": "attr",
        "cov_epoch": "cov",
        "corr_leak_epoch": "corr_leak",
        "cross_cov_epoch": "cross_cov",
        "rank_epoch": "rank",
        "matchstd_epoch": "matchstd",
        "matchstd_std0_epoch": "matchstd_std0",
        "matchstd_stdref_epoch": "matchstd_stdref",
        "sens_epoch": "sens",
        "sens_delta_epoch": "sens_delta",
    }

    def save_logs(self):
        """Reference-format Stage-2 Logs.pth (ref: train_MLP_VAE_deep_sdf.py:140-192)."""
        if not self.is_main:
            return
        torch.save(dict(self.logs_history, epoch=self.epoch, loss=self.loss_log),
                   ws.get_logs_filename(self.experiment_directory))

    def load_logs(self):
        """Resume of the log histories, clipped to the resumed epoch
        (msd_tpu/train/stage2.py:1121-1144)."""
        path = ws.get_logs_filename(self.experiment_directory)
        if not os.path.isfile(path):
            return
        data = torch.load(path, map_location="cpu", weights_only=False)
        self.logs_history = {k: list(data.get(k, []))[: self.epoch]
                             for k in list(self._LOG_FAMILIES) + ["learning_rate", "timing"]}
        self.loss_log = list(data.get("loss", []))
        self.loss_log_epoch = list(data.get("loss_epoch", []))[: self.epoch]
        n_epochs_logged = len(data.get("loss_epoch", []))
        if n_epochs_logged:
            self.loss_log = self.loss_log[: (len(self.loss_log) // n_epochs_logged) * self.epoch]
        else:
            self.loss_log = []

    def resume(self, continue_from: str) -> int:
        """Load the VAE, the decoder, the optimizer and the logs; returns the
        start epoch (msd_tpu/train/stage2.py:1146-1170)."""
        path = os.path.join(ws.get_model_params_dir(self.experiment_directory), continue_from + ".pth")
        data = torch.load(path, map_location="cpu", weights_only=False)
        self.vae.load_state_dict(data["vae_state_dict"])
        self.sdf_decoder.load_state_dict(data["sdf_decoder_state_dict"])
        try:
            ckpt.load_stage2_optimizer(self.experiment_directory, continue_from + ".pth", self.vae,
                                       self.sdf_decoder if self.train_sdf_decoder else None, self.optimizer)
        except Exception as exc:  # msd_tpu starts a fresh Adam state here too
            logging.warning("optimizer state not loaded (%s); reinitializing", exc)
            self.optimizer = GroupAdam(self.optimizer.groups)
        self.epoch = data["epoch"]
        try:
            self.load_logs()
        except Exception as exc:  # best effort, as msd_tpu
            logging.warning("Logs.pth not restored: %s", exc)
        for sched in self.lr_schedules:
            if isinstance(sched, StepLearningRateOnPlateauSchedule) and self.logs_history["learning_rate"]:
                sched.set_state(self.logs_history["learning_rate"][-1])
        # the point and noise draws continue where an unbroken run would be
        self.global_batch_idx = self.epoch * (len(self.train_indices) // self.scene_per_batch)
        self.start_epoch = self.epoch + 1
        return self.start_epoch

    # ------------------------------------------------------------------
    def get_eval_dataset(self, split_label: str):
        """The val/test SdfDataset, loaded at first use (None without one)."""
        if split_label in self._eval_datasets:
            return self._eval_datasets[split_label]
        split_file = {"val": self.val_split_file, "test": self.test_split_file}.get(split_label)
        ds = None
        if split_file and os.path.exists(str(split_file)):
            ds = SdfDataset.from_split(self.data_source, load_split(split_file), self.num_samp_per_scene,
                                       labels=self._labels_map)
        self._eval_datasets[split_label] = ds
        return ds

    def reconstruct_latents_for_dataset(self, dataset, num_iterations=None, num_samples=None, lr=None):
        """A Stage-1-style latent per shape of an eval split, fitted through
        the decoder with the port's ``reconstruct_batch`` (ref: :415-473).
        Returns [S, L] float32."""
        from msd_tpu_torch.train.reconstruct import reconstruct_batch

        g = lambda k, d: get_spec_with_default(self.specs, k, d)  # noqa: E731
        shapes = [(dataset.pos[i, : dataset.pos_counts[i]], dataset.neg[i, : dataset.neg_counts[i]])
                  for i in range(dataset.num_scenes)]
        _, latents = reconstruct_batch(
            self.sdf_decoder, int(num_iterations or g("EvalTestOptimizationSteps", 1000)), self.latent_size,
            shapes, float(g("EvalTestLatentInitStd", 0.01)), self.clamp_dist,
            num_samples=int(num_samples or g("EvalTestNumSamples", self.num_samp_per_scene)),
            lr=float(lr or g("EvalTestLatentLR", 5e-3)), l2reg=bool(g("EvalTestLatentL2Reg", True)),
        )
        return latents.detach().cpu().numpy().astype(np.float32)

    def eval_split(self, epoch: int, split_label: str, teacher_latents: np.ndarray, dataset):
        """SAP and correlation on an eval split: the VAE's mu of the split's
        (reconstructed) latents against its labels (ref: :3433-3826). In
        points mode the split has no VAE inputs and nothing is scored, where
        ``msd_tpu`` hands its latents to the point encoder, which cannot
        take them (msd_tpu/train/stage2.py:1231)."""
        from msd_tpu_torch.metrics import sap as sap_metric
        from msd_tpu_torch.train.stage2_eval import _eval_inputs, cached_mu  # stage2_eval imports this module

        inputs = _eval_inputs(self, dataset, teacher_latents)
        if inputs is None:
            return {}
        mu = np.asarray(cached_mu(self, inputs))
        results = {}
        label_matrix = self.metric_label_matrix(dataset)
        if label_matrix is not None:
            labels = label_matrix[:, self.label_index].astype(float)
            mask = np.isfinite(labels) & (labels != -1)
            if mask.sum() >= 4:
                try:
                    results["sap"] = sap_metric.sap(
                        labels[mask].reshape(-1, 1), mu[mask],
                        continuous_factors=self.label_task_type not in _CLASSIFICATION,
                        regression=self.label_task_type in ("regression", "reg", "continuous"),
                    )
                    self.writer.add_scalar(f"SAP/vae_{split_label}", results["sap"], epoch)
                except Exception as e:  # a metric failure must not stop training (msd_tpu logs it too)
                    logging.warning("SAP skipped (%s): %s", split_label, e)
                if np.std(mu[mask, 0]) > 0 and np.std(labels[mask]) > 0:
                    results["corr"] = float(np.corrcoef(mu[mask, 0], labels[mask])[0, 1])
                    self.writer.add_scalar(f"Correlation/{split_label}_latent0_label", results["corr"], epoch)
        return results


def main_function(experiment_directory: str, continue_from=None, batch_split: int = 1, device="cuda"):
    trainer = Stage2Trainer(experiment_directory, device=device)
    start_epoch = 1
    if continue_from is not None:
        logging.info('continuing from "%s"', continue_from)
        start_epoch = trainer.resume(continue_from)
    try:
        trainer.train(start_epoch=start_epoch, batch_split=int(batch_split))
    except KeyboardInterrupt:
        logging.error("Received KeyboardInterrupt. Cleaning up and ending training.")
    finally:
        if trainer._writer is not None:
            scalar_keys = ("CodeLength", "NumEpochs", "SamplesPerScene", "ScenesPerBatch", "ClampingDistance",
                           "VAELatentDim", "VAEReconWeight", "VAEKLWeight", "SDFLossWeight", "SNNLWeight",
                           "CorrLeakageLambda")
            hparams = {k: trainer.specs[k] for k in scalar_keys if k in trainer.specs}
            final = {"final_loss": trainer.loss_log_epoch[-1] if trainer.loss_log_epoch else float("nan")}
            if trainer.last_holdout_sap is not None:
                final["final_holdout_sap"] = trainer.last_holdout_sap
            if trainer.last_train_sap is not None:
                final["final_train_sap"] = trainer.last_train_sap
            try:
                trainer.writer.add_hparams(hparams, final)
            except Exception as exc:  # the writer's own hparams summary is best effort, as in msd_tpu
                logging.warning("hparams summary skipped: %s", exc)
            trainer.writer.flush()
            trainer.writer.close()
    return trainer
