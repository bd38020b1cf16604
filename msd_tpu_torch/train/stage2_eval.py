"""Stage-2 evaluation blocks (counterpart of ``msd_tpu/train/stage2_eval.py``
and of ``Stage2Trainer._run_evals``): per-split VAE and SDF losses, SAP and
Locatello SAP, latent-label correlation, the diagnosis and age tables (CSV),
and per-split meshes (``create_mesh``, K1 on a GPU) with their Chamfer
distance (ref: train_MLP_VAE_deep_sdf.py:1684-2581, :3319-3913).

The VAE's random draws are torch generators' (run_eval seeds one per split,
epoch and batch; the meshes' z_hat draws from seed 0), so the losses and
meshes agree with ``msd_tpu``'s in distribution, not draw for draw.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.config import get_spec_with_default, resolve_spec_path
from msd_tpu_torch.metrics import sap as sap_metric
from msd_tpu_torch.train.stage2 import eval_mode, load_teacher_latents

_CLASSIFICATION = ("classification", "class", "cls", "binary")
_REGRESSION = ("regression", "reg", "continuous")


def _valid_mask(labels_np):
    return np.isfinite(labels_np) & (labels_np != -1)


def _eval_inputs(trainer, dataset=None, eval_latents=None):
    """The VAE input array of a split: in points mode its surface clouds
    (none for the val and test splits, which load without them, as
    ``msd_tpu``'s), else the train latents (or ``eval_latents``) for the
    train set and the split's latents for the others
    (msd_tpu/train/stage2_eval.py:26-35)."""
    points = trainer.vae_input_mode == "points"
    if dataset is None or dataset is trainer.dataset:
        if points:
            return trainer.dataset.surface_points
        return eval_latents if eval_latents is not None else trainer.teacher_latents
    return dataset.surface_points if points else eval_latents


def cached_mu(trainer, inputs):
    """The VAE's mu of a split's inputs, computed at most once per (epoch,
    inputs array): the eval blocks of one epoch share it. The cache resets
    when ``trainer.epoch`` moves and holds the inputs array, so an ``id``
    is never reused while its entry lives."""
    epoch = int(getattr(trainer, "epoch", -1))
    cache = getattr(trainer, "_eval_mu_cache", None)
    if cache is None or cache["epoch"] != epoch:
        cache = trainer._eval_mu_cache = {"epoch": epoch, "entries": {}}
    entry = cache["entries"].get(id(inputs))
    if entry is not None and entry[0] is inputs:
        return entry[1]
    mu = trainer.compute_vae_latents(inputs=inputs)
    cache["entries"][id(inputs)] = (inputs, mu)
    return mu


def _codes_for(trainer, dataset=None, eval_latents=None, scene_indices=None):
    inputs = _eval_inputs(trainer, dataset, eval_latents)
    if inputs is None:
        return None
    mu = cached_mu(trainer, inputs)
    return mu[np.asarray(scene_indices)] if scene_indices is not None else mu


def _labels_for(trainer, dataset, label_index, scene_indices=None, age=False):
    labels = trainer.metric_label_matrix(dataset if dataset is not None else trainer.dataset, age=age)
    if labels is None:
        return None
    labels_np = labels[:, int(label_index)].astype(float)
    return labels_np[np.asarray(scene_indices)] if scene_indices is not None else labels_np


def _vae_out(trainer, x, generator):
    """The VAE's outputs without dropout or autograd; the
    reparameterisation noise comes from ``generator``."""
    with eval_mode(trainer.vae):
        return trainer.vae(x, generator=generator)


def run_eval(trainer, epoch: int, split_label: str, dataset=None, eval_latents=None, scene_indices=None,
             kl_weight: float = 0.0, code_reg_weight: float = 0.0, writer=None):
    """Per-split VAE + SDF losses (ref: :1684-1847): the plain VAE
    objective (recon + KL, whatever the training objective) plus the
    SDF-consistency loss on the split's sample points through the decoder
    (float32), averaged per batch. Returns the eval metrics or None. In
    points mode the VAE encodes the split's clouds and reconstructs its
    teacher latents; without them (msd_tpu/train/stage2_eval.py:107-116)
    the VAE terms are 0 and recon and KL NaN."""
    from msd_tpu_torch.data.sdf_samples import sample_sdf_batch
    from msd_tpu_torch.losses import vae as vl
    from msd_tpu_torch.losses.sdf import deep_sdf_loss
    from msd_tpu_torch.models.residual_mlp_vae import expand_latent_to_points

    ds = dataset if dataset is not None else trainer.dataset
    inputs = _eval_inputs(trainer, dataset, eval_latents)
    if ds is None or inputs is None:
        return None
    teacher = inputs
    if trainer.vae_input_mode == "points":
        teacher = eval_latents if dataset is not None and dataset is not trainer.dataset else trainer.teacher_latents
    scene_indices = np.arange(ds.num_scenes) if scene_indices is None else np.asarray(scene_indices)
    if len(scene_indices) == 0:
        return None
    dev = trainer.device
    P, clamp = trainer.num_samp_per_scene, trainer.clamp_dist
    pos, pc, neg, nc = ds.device_arrays(dev)
    inputs_dev = torch.as_tensor(np.asarray(inputs, np.float32), device=dev)
    teacher_dev = torch.as_tensor(np.asarray(teacher, np.float32), device=dev) if teacher is not None else None
    B = min(trainer.scene_per_batch, len(scene_indices))
    rows = []
    dec = trainer.sdf_decoder
    with eval_mode(trainer.vae, dec):
        for bi, start in enumerate(range(0, len(scene_indices), B)):
            sel = torch.as_tensor(scene_indices[start:start + B], device=dev)
            # one stream per (Seed, split, epoch, batch)
            tag = f"{trainer.seed}/{split_label}/{epoch}/{bi}".encode()
            gen = torch.Generator(device=dev).manual_seed(int(hashlib.sha256(tag).hexdigest()[:15], 16))
            batch = sample_sdf_batch(pos, pc, neg, nc, sel, P, gen)
            out = trainer.vae(inputs_dev[sel], generator=gen)
            if teacher_dev is not None:
                vae_total, recon, kl = vl.vae_loss(out["z_hat"], teacher_dev[sel], out["mu"], out["logvar"],
                                                   recon_weight=trainer.vae_recon_weight, kl_weight=kl_weight,
                                                   recon_loss=trainer.recon_loss_type)
            else:
                vae_total = torch.zeros((), device=dev)
                recon = kl = torch.full((), float("nan"), device=dev)
            lat_pts, xyz_flat = expand_latent_to_points(out["z_hat"], batch[:3].permute(1, 2, 0))
            pred = dec(torch.cat([lat_pts, xyz_flat], dim=1)).clamp(-clamp, clamp)
            gt = batch[3].reshape(-1, 1).clamp(-clamp, clamp)
            _, sdf_l, sdf_reg = deep_sdf_loss(pred, gt, lat_pts, code_reg_lambda=trainer.code_reg_lambda,
                                              code_reg_weight=code_reg_weight)
            total = trainer.sdf_loss_weight * (sdf_l + sdf_reg) + vae_total
            lat_mag = torch.linalg.vector_norm(out["mu"], dim=1).mean()
            rows.append(torch.stack([total, sdf_l, sdf_reg, recon, kl, lat_mag]))
    m = torch.stack(rows).cpu().numpy().astype(np.float64)  # per-batch means, averaged equally like the ref
    names = ("eval_loss", "eval_sdf_loss", "eval_sdf_reg", "eval_vae_recon", "eval_vae_kl", "eval_vae_lat_mag")
    eval_metrics = {k: float(np.mean(m[:, j])) for j, k in enumerate(names)}
    logging.info(
        "%s eval loss: %.6f | sdf: %.6f | sdf_reg: %.6f | vae_recon: %.6f | vae_kl: %.6f",
        split_label, eval_metrics["eval_loss"], eval_metrics["eval_sdf_loss"], eval_metrics["eval_sdf_reg"],
        eval_metrics["eval_vae_recon"], eval_metrics["eval_vae_kl"],
    )
    w = writer if writer is not None else trainer.writer
    w.add_scalar(f"Loss/{split_label}", eval_metrics["eval_loss"], epoch)
    w.add_scalar(f"Loss/{split_label}_sdf", eval_metrics["eval_sdf_loss"], epoch)
    w.add_scalar(f"Loss/{split_label}_reg", eval_metrics["eval_sdf_reg"], epoch)
    w.add_scalar(f"Loss/{split_label}_vae_recon", eval_metrics["eval_vae_recon"], epoch)
    w.add_scalar(f"Loss/{split_label}_vae_kl", eval_metrics["eval_vae_kl"], epoch)
    w.add_scalar(f"Mean Latent Magnitude/{split_label}", eval_metrics["eval_vae_lat_mag"], epoch)
    return eval_metrics


def compute_disentanglement_metrics(trainer, epoch: int, split_label: str, scene_indices=None, writer=None,
                                    dataset=None, eval_latents=None):
    """SAP (and Locatello SAP) on the diagnosis label and SAP-age on the age
    label over the VAE's mu (ref: :1911-1995). Returns {sap,
    sap_locatello, sap_age}."""
    specs = trainer.specs
    g = lambda k, d: get_spec_with_default(specs, k, d)  # noqa: E731
    ds = dataset if dataset is not None else trainer.dataset
    compute_sap, compute_sap_age = g("ComputeSAP", False), g("ComputeSAPAge", False)
    if not compute_sap and not compute_sap_age:
        return {}
    labels = trainer.metric_label_matrix(ds)
    if labels is None:
        return {}
    task = trainer.label_task_type
    if "SAPRegression" in specs:
        sap_regression = specs["SAPRegression"]
    elif task in _CLASSIFICATION or task in _REGRESSION:
        sap_regression = task in _REGRESSION
    else:
        sap_regression = False
    if "SAPContinuousFactors" in specs:
        sap_continuous = specs["SAPContinuousFactors"]
    elif task in _CLASSIFICATION or task in _REGRESSION:
        sap_continuous = task in _REGRESSION
    else:
        sap_continuous = True
    sap_nb_bins = g("SAPNumBins", 10)
    sap_label_indices = g("SAPLabelIndices", None) or [trainer.label_index]

    codes = _codes_for(trainer, dataset, eval_latents, scene_indices)
    if codes is None:
        logging.warning("SAP skipped (%s): VAE inputs unavailable.", split_label)
        return {}
    if scene_indices is not None:
        labels = labels[np.asarray(scene_indices)]

    out = {"sap": None, "sap_locatello": None, "sap_age": None}
    if compute_sap:
        factors = labels[:, [int(i) for i in sap_label_indices]]
        mask = _valid_mask(factors).all(axis=1)
        if mask.sum() >= 4:
            f_np, c_np = factors[mask], codes[mask]
            out["sap"] = sap_metric.sap(f_np, c_np, continuous_factors=sap_continuous, nb_bins=sap_nb_bins,
                                        regression=sap_regression)
            if not sap_regression and not sap_continuous:
                try:
                    out["sap_locatello"], _ = sap_metric.sap_binary_classification_locatello(f_np, c_np)
                except Exception as exc:  # a metric failure must not stop training (msd_tpu logs it too)
                    logging.warning("Locatello SAP skipped (%s): %s", split_label, exc)
            if writer is not None:
                writer.add_scalar(f"SAP/vae_{split_label}", out["sap"], epoch)
                if out["sap_locatello"] is not None:
                    writer.add_scalar(f"SAP/vae_locatello_{split_label}", out["sap_locatello"], epoch)

    age_labels = labels
    if compute_sap_age and trainer.sap_age_corr_labels_file != trainer.sap_corr_labels_file:
        # SAP-age may read its own labels file (ref: :1958-1966)
        age_labels = trainer.metric_label_matrix(ds, age=True)
        if age_labels is not None and scene_indices is not None:
            age_labels = age_labels[np.asarray(scene_indices)]
    if compute_sap_age and age_labels is not None:
        age_idx = g("SAPAgeLabelIndices", None) or [trainer.age_snnl_reg_label_index]
        factors = age_labels[:, [int(i) for i in age_idx]]
        mask = _valid_mask(factors).all(axis=1)
        if mask.sum() >= 4:
            out["sap_age"] = sap_metric.sap(
                factors[mask], codes[mask], continuous_factors=g("SAPAgeContinuousFactors", True),
                nb_bins=g("SAPAgeNumBins", sap_nb_bins), regression=g("SAPAgeRegression", True),
            )
            if writer is not None:
                writer.add_scalar(f"SAP/vae_{split_label}_age", out["sap_age"], epoch)
    parts = [f"{k}={v:.6f}" for k, v in out.items() if v is not None]
    if parts:
        logging.info("Epoch %d metrics (%s): %s", epoch, split_label, " | ".join(parts))
    return out


def _corr(x, y):
    if np.std(x) == 0 or np.std(y) == 0:
        return float("nan")
    return float(np.corrcoef(x, y)[0, 1])


def compute_latent_label_correlation(trainer, epoch, split_label, scene_indices=None, writer=None, dataset=None,
                                     eval_latents=None):
    """corr(latent 0, diagnosis label) (ref: :2114-2170)."""
    labels_np = _labels_for(trainer, dataset, trainer.label_index, scene_indices)
    codes = _codes_for(trainer, dataset, eval_latents, scene_indices)
    if labels_np is None or codes is None:
        return None
    mask = _valid_mask(labels_np)
    if mask.sum() < 2:
        return None
    corr = _corr(codes[mask, 0], labels_np[mask])
    if writer is not None:
        writer.add_scalar(f"Correlation/{split_label}_latent0_label", corr, epoch)
    logging.info("Epoch %d correlation (%s): latent0 vs label[%d] = %.6f", epoch, split_label, trainer.label_index,
                 corr)
    return corr


def latent_label_table(trainer, epoch, split_label, label_index, scene_indices=None, regression=True, nb_bins=10,
                       dataset=None, eval_latents=None, age=False):
    """Per-dim (dim, corr, sap) rows (ref: :2172-2434)."""
    labels_np = _labels_for(trainer, dataset, label_index, scene_indices, age=age)
    codes = _codes_for(trainer, dataset, eval_latents, scene_indices)
    if labels_np is None or codes is None:
        return []
    mask = _valid_mask(labels_np)
    if mask.sum() < 2:
        return []
    labels_np, latents = labels_np[mask], codes[mask]
    try:
        sap_scores = sap_metric.sap_score_matrix(labels_np.reshape(-1, 1), latents, continuous_factors=regression,
                                                 nb_bins=nb_bins, regression=regression)[0]
    except ValueError:
        sap_scores = np.full(latents.shape[1], np.nan)
    return [(dim, _corr(latents[:, dim], labels_np), float(sap_scores[dim])) for dim in range(latents.shape[1])]


def write_age_table(trainer, epoch, split_label, scene_indices=None, dataset=None, eval_latents=None):
    """AgeTables CSV: dim,corr,sap_r2,pred_mean,pred_std (ref: :2436-2581)."""
    g = lambda k, d: get_spec_with_default(trainer.specs, k, d)  # noqa: E731
    age_idx = g("AgeLabelIndexForTable", None)
    if age_idx is None:
        age_indices = g("SAPAgeLabelIndices", None)
        age_idx = int(age_indices[0]) if age_indices else int(trainer.age_snnl_reg_label_index)
    rows3 = latent_label_table(trainer, epoch, split_label, age_idx, scene_indices,
                               regression=g("SAPAgeRegression", True), nb_bins=g("SAPAgeNumBins", 10),
                               dataset=dataset, eval_latents=eval_latents, age=True)
    if not rows3:
        return None
    labels_np = _labels_for(trainer, dataset, age_idx, scene_indices, age=True)
    codes = _codes_for(trainer, dataset, eval_latents, scene_indices)
    mask = _valid_mask(labels_np)
    labels_v, latents = labels_np[mask], codes[mask]
    table_dir = os.path.join(trainer.experiment_directory, ws.tb_logs_dir, "AgeTables")
    os.makedirs(table_dir, exist_ok=True)
    table_path = os.path.join(table_dir, f"age_table_{split_label}_epoch_{epoch}.csv")
    logging.info("Epoch %d age latent table (%s):", epoch, split_label)
    logging.info("  dim | corr | sap_r2 | pred_mean | pred_std")
    with open(table_path, "w", encoding="utf-8") as f:
        f.write("dim,corr,sap_r2,pred_mean,pred_std\n")
        for dim, corr, sap_val in rows3:
            x = latents[:, dim]
            vx = np.var(x)
            if vx > 0:
                # least-squares slope from matched ddof=0 sums
                a = np.mean((x - x.mean()) * (labels_v - labels_v.mean())) / vx
                pred = a * (x - x.mean()) + labels_v.mean()
            else:
                pred = np.full_like(labels_v, labels_v.mean())
            pm, ps = float(np.mean(pred)), float(np.std(pred))
            logging.info("  %3d | %6.3f | %6.3f | %9.4f | %8.4f", dim, corr, sap_val, pm, ps)
            f.write(f"{dim},{corr:.6f},{sap_val:.6f},{pm:.6f},{ps:.6f}\n")
    return table_path


def write_diagnosis_table(trainer, epoch, split_label, scene_indices=None, dataset=None, eval_latents=None):
    """Per-dim latent-vs-diagnosis tables (ref: :2171-2434). Regression
    labels log dim|corr|sap_r2; classification labels log tables A (corr,
    SAP acc/err, Kumar-holdout acc) and B (holdout err, Locatello acc/err).
    Returns the row list (A rows for classification)."""
    specs = trainer.specs
    g = lambda k, d: get_spec_with_default(specs, k, d)  # noqa: E731
    labels_np = _labels_for(trainer, dataset, trainer.label_index, scene_indices)
    codes = _codes_for(trainer, dataset, eval_latents, scene_indices)
    if labels_np is None or codes is None:
        logging.warning("Latent table skipped (%s): inputs unavailable.", split_label)
        return []
    mask = _valid_mask(labels_np)
    if mask.sum() < 2:
        logging.warning("Latent table skipped (%s): insufficient valid labels.", split_label)
        return []
    labels_np = labels_np[mask].astype(float)
    latents = codes[mask]
    task = trainer.label_task_type
    sap_regression = g("SAPRegression", task in _REGRESSION)
    sap_continuous = g("SAPContinuousFactors", task not in _CLASSIFICATION)
    sap_nb_bins = g("SAPNumBins", 10)
    is_regression = bool(sap_regression or sap_continuous)

    sap_scores = None
    if g("ComputeSAP", False):
        try:
            sap_matrix = sap_metric.sap_score_matrix(labels_np.reshape(-1, 1), latents,
                                                     continuous_factors=sap_continuous, nb_bins=sap_nb_bins,
                                                     regression=sap_regression)
            if sap_matrix.shape[0] > 0:
                sap_scores = sap_matrix[0]
        except ValueError as exc:
            logging.warning("SAP per-latent scores unavailable (%s): %s", split_label, exc)

    debug_preds = bool(g("SAPDebugPredictions", False))
    debug_pred_n = int(g("SAPDebugPredSamples", 0))
    sap_pred_info = None
    if debug_preds:
        factors = labels_np.reshape(-1, 1)
        try:
            if is_regression:
                sap_pred_info = sap_metric.sap_regression_predictions(factors, latents, pred_sample_n=debug_pred_n)
            else:
                sap_pred_info = sap_metric.sap_classification_predictions(
                    factors, latents, continuous_factors=sap_continuous, nb_bins=sap_nb_bins,
                    pred_sample_n=debug_pred_n)
        except ValueError as exc:
            logging.warning("SAP prediction debug unavailable (%s): %s", split_label, exc)

    if is_regression:
        logging.info("Epoch %d latent vs label table (%s):", epoch, split_label)
        logging.info("  dim | corr | sap_r2")
        rows = []
        for dim in range(latents.shape[1]):
            sap_val = float(sap_scores[dim]) if sap_scores is not None else float("nan")
            rows.append((dim, _corr(latents[:, dim], labels_np), sap_val))
            logging.info("  %3d | %6.3f | %6.3f", dim, rows[-1][1], sap_val)
        if debug_preds and sap_pred_info is not None:
            logging.info("  dim | sap_pred_mean | sap_pred_std | sap_pred_sample")
            for dim in range(latents.shape[1]):
                info = sap_pred_info[0][dim]
                logging.info("  %3d | %12s | %12s | %s", dim,
                             "n/a" if not info else "%.4f" % info.get("pred_mean", float("nan")),
                             "n/a" if not info else "%.4f" % info.get("pred_std", float("nan")),
                             "n/a" if not info or info.get("pred_sample") is None else info["pred_sample"])
        return rows

    labels_int = labels_np.astype(int)
    unique_labels, unique_counts = np.unique(labels_int, return_counts=True)
    logging.info("  label balance (%s): %s", split_label,
                 {int(k): int(v) for k, v in zip(unique_labels, unique_counts)})
    loc_err_matrix = loc_pred_info = None
    try:
        if debug_preds:
            _, loc_err_matrix, loc_pred_info = sap_metric.sap_binary_classification_locatello(
                labels_int.reshape(-1, 1), latents, return_predictions=True, pred_sample_n=debug_pred_n)
        else:
            _, loc_err_matrix = sap_metric.sap_binary_classification_locatello(labels_int.reshape(-1, 1), latents)
    except ValueError as exc:
        logging.warning("Locatello SAP per-latent scores unavailable (%s): %s", split_label, exc)
    sap_holdout_test_acc = sap_holdout_pred_info = None
    sap_kumar_holdout = bool(g("SAPKumarHoldout", False))
    if sap_kumar_holdout:
        try:
            _, sap_holdout_test_acc, sap_holdout_pred_info = sap_metric.sap_classification_holdout_predictions(
                labels_int.reshape(-1, 1), latents, continuous_factors=sap_continuous, nb_bins=sap_nb_bins,
                train_frac=float(g("SAPKumarHoldoutFrac", 0.8)), random_state=g("SAPKumarHoldoutSeed", 0),
                pred_sample_n=debug_pred_n if debug_preds else 0)
        except ValueError as exc:
            logging.warning("Kumar holdout SAP unavailable (%s): %s", split_label, exc)

    logging.info("Epoch %d latent vs diagnosis tables (%s):", epoch, split_label)
    logging.info("  table A: dim | corr | sap_acc | sap_err | sap_hold_acc")
    logging.info("  table B: dim | sap_hold_err | loc_acc | loc_err")
    rows_a, rows_b = [], []
    for dim in range(latents.shape[1]):
        sap_val = float(sap_scores[dim]) if sap_scores is not None else float("nan")
        sap_err = 1.0 - sap_val if np.isfinite(sap_val) else float("nan")
        hold_val = hold_err = float("nan")
        if sap_holdout_test_acc is not None:
            hold_val = float(sap_holdout_test_acc[0][dim])
            if np.isfinite(hold_val):
                hold_err = 1.0 - hold_val
        loc_err = loc_val = float("nan")
        if loc_err_matrix is not None and loc_err_matrix.shape[0] > 0:
            loc_err = float(loc_err_matrix[0][dim])
            if np.isfinite(loc_err):
                loc_val = 1.0 - loc_err
        rows_a.append((dim, _corr(latents[:, dim], labels_np), sap_val, sap_err, hold_val))
        rows_b.append((dim, hold_err, loc_val, loc_err))
    for dim, corr, sap_val, sap_err, hold_val in rows_a:
        logging.info("  A %3d | %6.3f | %7.3f | %7.3f | %12.3f", dim, corr, sap_val, sap_err, hold_val)
    for dim, hold_err, loc_val, loc_err in rows_b:
        logging.info("  B %3d | %12.3f | %7.3f | %7.3f", dim, hold_err, loc_val, loc_err)
    if sap_holdout_test_acc is not None:
        vals = sap_holdout_test_acc[0]
        vals = np.sort(vals[np.isfinite(vals)])
        if vals.size >= 2:
            logging.info("Epoch %d Kumar SAP holdout gap (%s): %.6f", epoch, split_label, float(vals[-1] - vals[-2]))
    if debug_preds:
        if sap_kumar_holdout:
            logging.info("  dim | sap_pred_counts | sap_hold_pred_counts | loc_pred_counts"
                         " | sap_pred_sample | sap_hold_pred_sample | loc_pred_sample")
        else:
            logging.info("  dim | sap_pred_counts | loc_pred_counts | sap_pred_sample | loc_pred_sample")
        for dim in range(latents.shape[1]):
            sap_info = sap_pred_info[0][dim] if sap_pred_info else None
            loc_info = loc_pred_info[0][dim] if loc_pred_info else None
            hold_info = sap_holdout_pred_info[0][dim] if sap_holdout_pred_info else None
            cells = [sap_info.get("pred_counts") if sap_info else None]
            if sap_kumar_holdout:
                cells.append(hold_info.get("test_pred_counts") if hold_info else None)
            cells += [loc_info.get("pred_counts") if loc_info else None,
                      sap_info.get("pred_sample") if sap_info else None]
            if sap_kumar_holdout:
                cells.append(hold_info.get("test_pred_sample") if hold_info else None)
            cells.append(loc_info.get("pred_sample") if loc_info else None)
            logging.info("  %3d | " + " | ".join("%s" for _ in cells), dim, *("n/a" if c is None else c for c in cells))
    return rows_a


def _zhat_for_scenes(trainer, scene_indices, dataset=None, eval_latents=None):
    """(dataset, z_hat [len(idx), L] on the device) of selected scenes, or
    (dataset, None) when the split has no latents."""
    ds = dataset if dataset is not None else trainer.dataset
    inputs = _eval_inputs(trainer, dataset, eval_latents)
    if inputs is None:
        return ds, None
    x = torch.as_tensor(np.asarray(inputs, np.float32)[np.asarray(scene_indices)], device=trainer.device)
    return ds, _vae_out(trainer, x, torch.Generator(device=trainer.device).manual_seed(0))["z_hat"]


def generate_eval_meshes(trainer, epoch, split_label, scene_indices, resolution=None, writer=None, dataset=None,
                         eval_latents=None, return_meshes=False):
    """The selected scenes' z_hat meshed by the port's ``create_mesh`` (K1 on
    a GPU) under the TensorBoard reconstruction dirs (ref: :1997-2047).
    With ``return_meshes`` returns (written ids, {scene index: (verts,
    faces)}) for a following Chamfer pass."""
    from msd_tpu_torch import mesh as mesh_mod

    if scene_indices is None or len(scene_indices) == 0:
        return ([], {}) if return_meshes else []
    g = lambda k, d: get_spec_with_default(trainer.specs, k, d)  # noqa: E731
    resolution = resolution or g("EvalGridResolution", 256)
    ds, z_hat = _zhat_for_scenes(trainer, scene_indices, dataset, eval_latents)
    if z_hat is None:
        logging.error("%s latents missing; skipping %s mesh generation.", split_label, split_label)
        return ([], {}) if return_meshes else []
    recon_dir = ws.tb_logs_train_reconstructions if split_label == "train" else ws.tb_logs_test_reconstructions
    written, meshes = [], {}
    dec = trainer.sdf_decoder
    with eval_mode(dec):
        for j, idx in enumerate(scene_indices):
            iid = ds.instance_ids[idx]
            out_dir = os.path.join(trainer.experiment_directory, ws.tb_logs_dir, recon_dir, iid)
            os.makedirs(out_dir, exist_ok=True)
            res = mesh_mod.create_mesh(dec, z_hat[j], filename=os.path.join(out_dir, f"epoch={epoch}"),
                                       N=resolution, max_batch=g("EvalMaxBatch", 2**18), return_mesh=True)
            if res is not False:
                written.append(iid)
                meshes[int(idx)] = res
    return (written, meshes) if return_meshes else written


def compute_chamfer_for_scenes(trainer, epoch, split_label, scene_indices, writer=None, dataset=None,
                               eval_latents=None, meshes=None):
    """Mean Chamfer of the selected scenes' meshes against EvalGTMeshDir
    (ref: :2049-2112); logs Chamfer/{split}. ``meshes`` from
    ``generate_eval_meshes(..., return_meshes=True)`` are reused. Returns
    the mean or None."""
    from msd_tpu_torch import mesh as mesh_mod
    from msd_tpu_torch.metrics.chamfer import compute_mesh_chamfer

    g = lambda k, d: get_spec_with_default(trainer.specs, k, d)  # noqa: E731
    gt_dir = g("EvalGTMeshDir", None)
    if gt_dir is None or scene_indices is None or len(scene_indices) == 0:
        return None
    ds, z_hat = _zhat_for_scenes(trainer, scene_indices, dataset, eval_latents)
    if z_hat is None:
        logging.error("%s latents missing; skipping %s Chamfer.", split_label, split_label)
        return None
    cds = []
    for j, idx in enumerate(scene_indices):
        gt_path = os.path.join(str(gt_dir), ds.instance_ids[idx] + g("EvalGTMeshExt", ".obj"))
        if not os.path.isfile(gt_path):
            logging.warning("GT mesh missing for chamfer: %s", gt_path)
            continue
        res = meshes.get(int(idx)) if meshes is not None else None
        if res is None:
            with eval_mode(trainer.sdf_decoder):
                res = mesh_mod.create_mesh(trainer.sdf_decoder, z_hat[j], N=g("EvalGridResolution", 256),
                                           max_batch=g("EvalMaxBatch", 2**18), return_mesh=True)
        if res is False:
            continue
        cds.append(compute_mesh_chamfer(gt_path, res, num_mesh_samples=g("EvalGTMeshSamples", 30000))[0])
    if not cds:
        return None
    mean_cd = float(np.mean(cds))
    (writer if writer is not None else trainer.writer).add_scalar(f"Chamfer/{split_label}", mean_cd, epoch)
    return mean_cd


def eval_scene_selection(trainer, key: str, pool, default: int = 0):
    """A stable random subset of a scene pool, sized by a *SceneNumber spec
    (0 or absent: the whole pool; ref: :1306-1317), chosen once and cached
    by (key, pool contents)."""
    if not hasattr(trainer, "_eval_selections"):
        trainer._eval_selections = {}
    pool = np.asarray(pool)
    cache_key = (key, pool.shape, hash(pool.tobytes()))
    if cache_key not in trainer._eval_selections:
        n = int(get_spec_with_default(trainer.specs, key, default) or 0)
        if n <= 0 or n >= len(pool):
            sel = pool
        else:
            rng = np.random.default_rng(get_spec_with_default(trainer.specs, "Seed", 0))
            sel = np.sort(rng.choice(pool, size=n, replace=False))
        trainer._eval_selections[cache_key] = sel
    return trainer._eval_selections[cache_key]


def run_evals(trainer, epoch):
    """The periodic eval blocks of ``msd_tpu``'s ``Stage2Trainer._run_evals``
    (msd_tpu/train/stage2.py:1364-1518): per-split losses, SAP,
    correlation and tables, and meshes with their Chamfer on the train,
    holdout, val and test splits."""
    g = lambda k, d: get_spec_with_default(trainer.specs, k, d)  # noqa: E731
    kl_weight, code_reg_weight = trainer._last_kl_weight, trainer._last_code_reg_weight
    w = trainer.writer
    # meshes are opt-in (EvalGridResolution or a GT mesh dir), as msd_tpu
    mesh_gate = ("EvalGridResolution" in trainer.specs) or bool(g("EvalGTMeshDir", None))

    eval_train_frequency = g("EvalTrainFrequency", 0)
    if eval_train_frequency and epoch % eval_train_frequency == 0:
        em = run_eval(trainer, epoch, "eval_train",
                      scene_indices=eval_scene_selection(trainer, "EvalTrainSceneNumber", trainer.train_indices),
                      kl_weight=kl_weight, code_reg_weight=code_reg_weight, writer=w)
        if em is not None:
            trainer.last_eval_metrics = dict(em, split="eval_train", epoch=epoch)

        def label_metrics(split_label, indices):
            m = compute_disentanglement_metrics(trainer, epoch, split_label, indices, w)
            compute_latent_label_correlation(trainer, epoch, split_label, indices, w)
            write_diagnosis_table(trainer, epoch, split_label, indices)
            if trainer.compute_sap_age:
                write_age_table(trainer, epoch, split_label, indices)
            return m

        tm = label_metrics("train", trainer.train_indices)
        if tm and tm.get("sap") is not None:
            trainer.last_train_sap = tm["sap"]
        if len(trainer.holdout_indices):
            hm = label_metrics("train_holdout", trainer.holdout_indices)
            if hm and hm.get("sap") is not None:
                trainer.last_holdout_sap = hm["sap"]
            hold_em = run_eval(
                trainer, epoch, "eval_train_holdout",
                scene_indices=eval_scene_selection(trainer, "EvalTestSceneNumber", trainer.holdout_indices),
                kl_weight=kl_weight, code_reg_weight=code_reg_weight, writer=w)
            if hold_em is not None:
                trainer.last_holdout_eval_metrics = dict(hold_em, epoch=epoch)
        mesh_idx = eval_scene_selection(trainer, "EvalMeshTrainSceneNumber", trainer.train_indices, 10)
        if mesh_gate and len(mesh_idx):
            _, meshes = generate_eval_meshes(trainer, epoch, "train", mesh_idx, writer=w, return_meshes=True)
            cd = compute_chamfer_for_scenes(trainer, epoch, "train", mesh_idx, writer=w, meshes=meshes)
            if cd is not None:
                logging.info("Epoch %d train chamfer: %.6f (mesh_count=%d)", epoch, cd, len(mesh_idx))

    # val/test latent re-optimisation evals (ref: :415-473, :3583-3913)
    eval_test_frequency = g("EvalTestFrequency", 0)
    eval_val_frequency = g("EvalValFrequency", eval_test_frequency)
    for split_label, freq, gate_key, start_key, latent_key in (
        ("test", eval_test_frequency, "EvalTestReconstructLatents", "EvalTestStartEpoch", "TestLatentPath"),
        ("val", eval_val_frequency, "EvalValReconstructLatents", "EvalValStartEpoch", "ValLatentPath"),
    ):
        if not freq or epoch % freq != 0 or epoch < g(start_key, 1):
            continue
        reconstruct_gate = g(gate_key, False)
        latent_path = resolve_spec_path(g(latent_key, None), trainer.experiment_directory)
        if not reconstruct_gate and latent_path is None:
            continue
        dataset = trainer.get_eval_dataset(split_label)
        if dataset is None:
            continue
        if reconstruct_gate:
            logging.info("reconstructing %s-split latents for eval...", split_label)
            teacher = trainer.reconstruct_latents_for_dataset(dataset)
        else:
            teacher = load_teacher_latents(latent_path)
            if teacher.shape[0] != dataset.num_scenes:
                logging.warning("%s latents (%d) != %s scenes (%d); skipping eval", latent_key, teacher.shape[0],
                                split_label, dataset.num_scenes)
                continue
        scene_num_key = "EvalTestSceneNumber" if split_label == "test" else "EvalValSceneNumber"
        loss_idx = eval_scene_selection(trainer, scene_num_key, np.arange(dataset.num_scenes))
        run_eval(trainer, epoch, f"eval_{split_label}", dataset=dataset, eval_latents=teacher,
                 scene_indices=loss_idx, kl_weight=kl_weight, code_reg_weight=code_reg_weight, writer=w)
        compute_latent_label_correlation(trainer, epoch, split_label, loss_idx, w, dataset=dataset,
                                         eval_latents=teacher)
        write_diagnosis_table(trainer, epoch, split_label, loss_idx, dataset=dataset, eval_latents=teacher)
        if trainer.compute_sap_age:
            write_age_table(trainer, epoch, f"{split_label}_age", loss_idx, dataset=dataset, eval_latents=teacher)
        results = trainer.eval_split(epoch, split_label, teacher, dataset)
        logging.info("epoch %d %s eval: %s", epoch, split_label, results)
        mesh_key = "EvalMeshTestSceneNumber" if split_label == "test" else "EvalMeshValSceneNumber"
        mesh_idx = eval_scene_selection(trainer, mesh_key, np.arange(dataset.num_scenes), 10)
        if mesh_gate and len(mesh_idx):
            _, meshes = generate_eval_meshes(trainer, epoch, split_label, mesh_idx, writer=w, dataset=dataset,
                                             eval_latents=teacher, return_meshes=True)
            cd = compute_chamfer_for_scenes(trainer, epoch, split_label, mesh_idx, writer=w, dataset=dataset,
                                            eval_latents=teacher, meshes=meshes)
            if cd is not None:
                logging.info("Epoch %d %s chamfer: %.6f", epoch, split_label, cd)

    # lightweight extra SAP/corr + eval-loss pass between full evals (ref: :3499-3560)
    extra_freq = int(g("SAPCORRExtraFrequency", 0) or 0)
    if extra_freq > 0 and epoch % extra_freq == 0:
        full_eval_epoch = bool(eval_train_frequency and epoch % eval_train_frequency == 0)
        if trainer.compute_sap and not full_eval_epoch:
            tm = compute_disentanglement_metrics(trainer, epoch, "train_extra", trainer.train_indices, w)
            if tm and tm.get("sap") is not None:
                trainer.last_train_sap = tm["sap"]
        if not full_eval_epoch:
            em = run_eval(trainer, epoch, "eval_train_extra",
                          scene_indices=eval_scene_selection(trainer, "EvalTrainSceneNumber", trainer.train_indices),
                          kl_weight=kl_weight, code_reg_weight=code_reg_weight, writer=w)
            if em is not None:
                trainer.last_eval_metrics = dict(em, split="eval_train_extra", epoch=epoch)
        last = trainer.last_eval_metrics or {}

        def fmt(v):
            return "n/a" if v is None else "%.6f" % v

        logging.info("Epoch %d extra summary: train_sdf_loss=%s train_sap=%s", epoch,
                     fmt(last.get("eval_sdf_loss")), fmt(trainer.last_train_sap))
