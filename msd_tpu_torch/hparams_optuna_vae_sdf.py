"""Hyper-parameter search over the Stage-2 VAE (counterpart of the root
``hparams_optuna_vae_sdf.py``).

``python -m msd_tpu_torch.hparams_optuna_vae_sdf -b <base specs.json> [-o
<search_dir>] [-n trials] [--epochs E] [--seed S] [--device cuda|cpu]``
takes the root script's flags plus ``--device`` (default ``cuda``; asking
for ``cuda`` without a GPU raises before the first trial). Each trial
samples the search space (the root script's own Tree-structured Parzen
Estimator, no optuna), trains the port's ``Stage2Trainer`` in
``<search_dir>/trial_NNNN`` for ``--epochs`` epochs and is scored on the
latent holdout as

    0.6 * SAP_holdout + 0.3 * |corr(latent0, label)| - 0.1 * recon

(ref: :42-46, :473-511). ``<search_dir>/trials.json`` is rewritten after
every trial, and a later run resumes from it; ``best.json`` holds the best
trial.

A trial whose training diverges or whose scoring fails (a non-finite
holdout recon, no holdout SAP) is recorded with ``"value": null``, as in
the root script. A fault of the card is not: a kernel that does not build
or launch (``ops._build.KernelError``), a CUDA error
(``torch.AcceleratorError``) or the card's memory exhausted
(``torch.cuda.OutOfMemoryError``) ends the search with the exception, after
``trials.json`` is written. The root script records every exception as a
failed trial, which would turn a broken card into a search of failed
trials that exits 0.

The sampler (``SEARCH_SPACE`` to ``build_trial_specs``) is a copy of the
root script's, numpy only: for the same generator state and history it
gives the same parameters, bit for bit.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import logging
import math
import os

import numpy as np
import torch

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.ops._build import KernelError
from msd_tpu_torch.train import stage2_eval as ev
from msd_tpu_torch.train.stage2 import Stage2Trainer
from msd_tpu_torch.utils import add_common_args, configure_logging

WEIGHTS = {"sap": 0.6, "corr": 0.3, "recon": 0.1}
DEFAULT_NUM_EPOCHS = 500
# failures that no trial's parameters cause: a kernel that did not build or
# launch, a CUDA error, the card's memory exhausted
CARD_FAULTS = (KernelError, torch.AcceleratorError, torch.cuda.OutOfMemoryError)

# (name, kind, args) mirroring the reference search space (ref: :356-406)
SEARCH_SPACE = [
    ("VAEReconWeight", "logfloat", (1e-3, 5e-1)),
    ("VAEKLWeight", "logfloat", (1e-4, 5e-2)),
    ("KLWarmupEpochs", "int", (0, 150)),
    ("CodeRegularizationLambda", "logfloat", (1e-6, 1e-3)),
    ("SNNLWeight", "float", (0.1, 1.0)),
    ("SNNLTemp", "logfloat", (1.0, 30.0)),
    ("AgeSNNLRegWeight", "float", (0.1, 1.0)),
    ("AgeSNNLRegTemp", "logfloat", (1.0, 30.0)),
    ("AgeSNNLRegThreshold", "categorical", ([0.15, 0.2],)),
    ("CovarianceLossLambda", "logfloat", (1e-3, 1.0)),
    ("CorrLeakageLambda", "logfloat", (1e-3, 5e-1)),
    ("LrInitial", "logfloat", (1e-4, 5e-3)),
    ("Lr2Ratio", "float", (0.05, 0.5)),
]


N_STARTUP = 10  # random trials before TPE engages (optuna default: 10)
N_EI_CANDIDATES = 24  # candidate draws from l(x) per parameter (optuna default)


def _random_one(rng, kind, args):
    if kind == "logfloat":
        lo, hi = args
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    if kind == "float":
        lo, hi = args
        return float(rng.uniform(lo, hi))
    if kind == "int":
        lo, hi = args
        return int(rng.integers(lo, hi + 1))
    choices = args[0]
    return choices[int(rng.integers(0, len(choices)))]


class _ParzenMixture:
    """Univariate truncated-Gaussian mixture over observed values plus a
    domain-wide prior component (the Parzen estimator of TPE).

    Bandwidth per component = max distance to its sorted neighbors,
    clipped to [(hi-lo)/min(100, 1+n), hi-lo] — the same heuristic optuna
    uses to keep early mixtures wide and late mixtures sharp."""

    def __init__(self, values, lo, hi):
        n = len(values)
        mus = np.sort(np.asarray(values, dtype=np.float64))
        width = hi - lo
        if n:
            padded = np.concatenate([[lo], mus, [hi]])
            sig = np.maximum(padded[2:] - padded[1:-1], padded[1:-1] - padded[:-2])
        else:
            sig = np.zeros(0)
        # prior component: uniform-ish Gaussian spanning the whole domain
        self.mus = np.concatenate([mus, [(lo + hi) / 2.0]])
        self.sigmas = np.clip(
            np.concatenate([sig, [width]]), width / min(100.0, 1.0 + n), width
        )
        self.weights = np.full(n + 1, 1.0 / (n + 1))
        self.lo, self.hi = lo, hi
        # truncation mass of each component inside [lo, hi]
        self.trunc = self._cdf((hi - self.mus) / self.sigmas) - self._cdf(
            (lo - self.mus) / self.sigmas
        )

    @staticmethod
    def _cdf(z):
        return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(z) / math.sqrt(2.0)))

    def sample(self, rng, size):
        comp = rng.choice(len(self.mus), size=size, p=self.weights)
        draws = rng.normal(self.mus[comp], self.sigmas[comp])
        # re-draw out-of-domain points a few rounds, then clip (truncation)
        for _ in range(8):
            bad = (draws < self.lo) | (draws > self.hi)
            if not bad.any():
                break
            draws[bad] = rng.normal(self.mus[comp[bad]], self.sigmas[comp[bad]])
        return np.clip(draws, self.lo, self.hi)

    def log_pdf(self, x):
        x = np.asarray(x, dtype=np.float64)[:, None]
        z = (x - self.mus[None, :]) / self.sigmas[None, :]
        comp = (
            -0.5 * z**2
            - np.log(self.sigmas[None, :] * math.sqrt(2.0 * math.pi))
            - np.log(np.maximum(self.trunc[None, :], 1e-12))
            + np.log(self.weights[None, :])
        )
        m = comp.max(axis=1, keepdims=True)
        return (m + np.log(np.exp(comp - m).sum(axis=1, keepdims=True))).ravel()


def _tpe_one(rng, kind, args, good_vals, bad_vals):
    """Sample candidates from the good-trial mixture l(x) and return the
    one maximizing the EI surrogate l(x)/g(x)."""
    if kind == "categorical":
        choices = list(args[0])

        def probs(vals):
            cnt = np.ones(len(choices), dtype=np.float64)  # +1 smoothing
            for v in vals:
                # trials.json may hold values from an edited SEARCH_SPACE
                # (resume after a choice was removed) — skip, don't crash
                if v in choices:
                    cnt[choices.index(v)] += 1.0
            return cnt / cnt.sum()

        pl, pg = probs(good_vals), probs(bad_vals)
        cand = rng.choice(len(choices), size=N_EI_CANDIDATES, p=pl)
        best = cand[np.argmax(np.log(pl[cand]) - np.log(pg[cand]))]
        return choices[int(best)]
    lo, hi = args
    log_space = kind == "logfloat"
    tf = math.log if log_space else float
    l_mix = _ParzenMixture([tf(v) for v in good_vals], tf(lo), tf(hi))
    g_mix = _ParzenMixture([tf(v) for v in bad_vals], tf(lo), tf(hi))
    cand = l_mix.sample(rng, N_EI_CANDIDATES)
    if kind == "int":
        cand = np.round(cand)
    x = cand[np.argmax(l_mix.log_pdf(cand) - g_mix.log_pdf(cand))]
    if kind == "int":
        return int(np.clip(round(x), lo, hi))
    v = math.exp(x) if log_space else float(x)
    return float(np.clip(v, lo, hi))


def sample_params(rng: np.random.Generator, history):
    """Random for the first ``N_STARTUP`` trials, then per-parameter TPE:
    completed trials split into good (top gamma) / bad, each modeled by a
    Parzen mixture; candidates drawn from l(x), scored by l(x)/g(x)."""
    complete = [t for t in history if t.get("value") is not None]
    if len(complete) < N_STARTUP:
        return {name: _random_one(rng, kind, args) for name, kind, args in SEARCH_SPACE}
    ranked = sorted(complete, key=lambda t: -t["value"])
    # optuna's default gamma: ceil(0.1 n) capped at 25 good trials
    n_good = min(max(1, math.ceil(0.1 * len(ranked))), 25)
    good, bad = ranked[:n_good], ranked[n_good:]
    params = {}
    for name, kind, args in SEARCH_SPACE:
        gv = [t["params"][name] for t in good if name in t.get("params", {})]
        bv = [t["params"][name] for t in bad if name in t.get("params", {})]
        if not gv or not bv:
            params[name] = _random_one(rng, kind, args)
        else:
            params[name] = _tpe_one(rng, kind, args, gv, bv)
    return params


def build_trial_specs(base_specs, params, num_epochs):
    """ref: :356-406."""
    specs = copy.deepcopy(base_specs)
    specs["NumEpochs"] = num_epochs
    specs["VAELatentDim"] = 8
    for k in (
        "VAEReconWeight", "VAEKLWeight", "KLWarmupEpochs", "CodeRegularizationLambda",
        "SNNLWeight", "SNNLTemp", "AgeSNNLRegWeight", "AgeSNNLRegTemp",
        "AgeSNNLRegThreshold", "CovarianceLossLambda", "CorrLeakageLambda",
    ):
        specs[k] = params[k]
    specs["AgeCorrLeakageLoss"] = False
    lr0 = params["LrInitial"]
    lr1 = lr0 * params["Lr2Ratio"]
    if "LearningRateSchedule" in specs and len(specs["LearningRateSchedule"]) >= 2:
        specs["LearningRateSchedule"][0]["Initial"] = lr0
        specs["LearningRateSchedule"][1]["Initial"] = lr1
    return specs


def _score(trainer):
    """The composite objective of a trained trial from its holdout's eval
    blocks (msd_tpu's ``run_trial`` scoring)."""
    epoch = trainer.epoch
    holdout = trainer.holdout_indices
    if not len(holdout):
        # scoring the training set as "holdout" would make the search
        # maximize overfitting with no warning
        raise ValueError(
            "HPO requires a latent holdout: set TrainLatentHoldoutFraction > 0 "
            "in the base specs"
        )
    metrics = ev.compute_disentanglement_metrics(trainer, epoch, "holdout", holdout)
    corr = ev.compute_latent_label_correlation(trainer, epoch, "holdout", holdout)
    # the recon term is the HOLDOUT eval recon; train recon would reward
    # overfitting
    em = ev.run_eval(
        trainer, epoch, "hpo_holdout", scene_indices=holdout,
        kl_weight=trainer._last_kl_weight, code_reg_weight=trainer._last_code_reg_weight,
    )
    recon = em["eval_vae_recon"] if em else float("nan")
    if not np.isfinite(recon):
        # a diverged or failed holdout eval means a broken model: fail the
        # trial (value None, which the sampler ignores)
        raise RuntimeError(f"holdout eval recon is non-finite ({recon}); failing trial")
    sap = metrics.get("sap") if metrics else None
    if sap is None or not np.isfinite(sap):
        # zeroing the dominant 0.6-weighted term would hide a
        # misconfiguration (labels, ComputeSAP, too small a holdout)
        raise RuntimeError(f"holdout SAP unavailable ({sap}); failing trial")
    corr_abs = abs(corr) if corr is not None and np.isfinite(corr) else 0.0
    value = WEIGHTS["sap"] * sap + WEIGHTS["corr"] * corr_abs - WEIGHTS["recon"] * recon
    return float(value), {"sap": sap, "corr": corr_abs, "recon": float(recon)}


def run_trial(trial_dir, specs, train_epochs=None, device="cuda"):
    """Save ``specs`` in ``trial_dir``, train the port's ``Stage2Trainer``
    there on ``device`` and score it on its holdout: (value, {sap, corr,
    recon}). The trainer's writer is closed whatever happens."""
    ws.save_experiment_specifications(trial_dir, specs)
    trainer = Stage2Trainer(trial_dir, device=device)
    try:
        trainer.train(num_epochs=train_epochs or specs["NumEpochs"])
        return _score(trainer)
    finally:
        if trainer._writer is not None:
            trainer._writer.close()


def _save_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _parser():
    p = argparse.ArgumentParser(description="Stage-2 VAE hyperparameter search")
    p.add_argument("--base_specs", "-b", required=True, help="base specs.json path")
    p.add_argument("--search_dir", "-o", default="outputs/optuna_vae_sdf")
    p.add_argument("--trials", "-n", type=int, default=20)
    p.add_argument("--epochs", type=int, default=DEFAULT_NUM_EPOCHS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", dest="device", default="cuda", help="cuda (default) or cpu")
    add_common_args(p)
    return p


def main(argv=None):
    """Run the search; returns the trials' history (trials.json's list)."""
    args = _parser().parse_args(argv)
    configure_logging(args)
    resolve_device(args.device)

    with open(args.base_specs) as f:
        base_specs = json.load(f)
    if float(base_specs.get("TrainLatentHoldoutFraction", 0.0)) <= 0.0:
        raise SystemExit(
            "HPO scores SAP/corr/recon on the latent holdout: set "
            "TrainLatentHoldoutFraction > 0 in the base specs"
        )
    os.makedirs(args.search_dir, exist_ok=True)
    trials_path = os.path.join(args.search_dir, "trials.json")
    history = []
    if os.path.isfile(trials_path):
        with open(trials_path) as f:
            history = json.load(f)

    rng = np.random.default_rng(args.seed + len(history))
    for i in range(len(history), len(history) + args.trials):
        params = sample_params(rng, history)
        specs = build_trial_specs(base_specs, params, args.epochs)
        trial_dir = os.path.join(args.search_dir, f"trial_{i:04d}")
        logging.info("trial %d: %s", i, params)
        try:
            value, detail = run_trial(trial_dir, specs, device=args.device)
            history.append({"trial": i, "params": params, "value": value, "detail": detail})
            logging.info("trial %d objective=%.6f detail=%s", i, value, detail)
        except CARD_FAULTS as e:
            logging.error("trial %d: the card failed, ending the search: %s", i, e)
            raise
        except Exception as e:
            logging.error("trial %d failed: %s", i, e)
            history.append({"trial": i, "params": params, "value": None, "error": str(e)})
        finally:
            _save_json(trials_path, history)
            gc.collect()  # the trial's trainer, and its tensors on the card, go before the next trial

    complete = [t for t in history if t.get("value") is not None]
    if complete:
        best = max(complete, key=lambda t: t["value"])
        logging.info("best trial: %s value=%.6f", best["trial"], best["value"])
        _save_json(os.path.join(args.search_dir, "best.json"), best)
    return history


if __name__ == "__main__":
    main()
