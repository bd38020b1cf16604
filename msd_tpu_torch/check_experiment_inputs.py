"""Preflight validator for experiment inputs (specs.json, splits, labels,
pretrained artifacts): the port's own copy of the root
``check_experiment_inputs.py`` (ref: check_experiment_inputs.py:1-291),
which prints the same report lines.

    python -m msd_tpu_torch.check_experiment_inputs -e <exp> [--max_samples N]

A table-driven check registry: each check is an independent function over
a shared context and emits report lines; ``main`` builds the context and
runs the table. Report line format: ``[section] message`` (stable: tests
and humans grep these), one line per fact, warnings inline. numpy and json
on the host; torch only reads latent files.
"""

import argparse
import json
import math
import os

import numpy as np


# ---------------------------------------------------------------------------
# context: everything checks may need, resolved once
# ---------------------------------------------------------------------------

class Ctx:
    def __init__(self, exp_dir: str, max_samples: int = 0):
        self.exp_dir = exp_dir
        self.max_samples = max_samples
        specs_path = os.path.join(exp_dir, "specs.json")
        if not os.path.isfile(specs_path):
            raise FileNotFoundError(f"specs.json not found: {specs_path}")
        with open(specs_path, encoding="utf-8") as f:
            self.specs = json.load(f)
        self.data_source = self.specs.get("DataSource")
        if self.data_source is None:
            raise ValueError("DataSource missing from specs")
        self.split_npy = {}        # split name -> npz paths (filled by check_splits)
        self.split_ids = {}        # split name -> set of instance ids

    # path conventions: spec-relative for experiment artifacts
    # (ref: train_MLP_VAE_deep_sdf.py:56-61), data-source-relative for labels
    def spec_path(self, key_or_value, *fallback_keys):
        v = key_or_value if "/" in str(key_or_value or "") or key_or_value is None \
            else self.specs.get(key_or_value)
        for k in fallback_keys:
            v = v or self.specs.get(k)
        if v is None:
            return None
        return v if os.path.isabs(v) else os.path.join(self.exp_dir, v)

    def label_path(self, value):
        if value is None:
            return None
        return value if os.path.isabs(value) else os.path.join(self.data_source, value)

    def label_indices(self):
        """Every label column any enabled metric/loss will read."""
        s = self.specs
        sap_age = s.get("SAPAgeLabelIndices") or []
        age_table = s.get("AgeLabelIndexForTable")
        if age_table is None:
            age_table = sap_age[0] if sap_age else int(s.get("AgeSNNLRegLabelIndex", 1))
        cols = {int(s.get("LabelIndex", 0)), int(s.get("AgeSNNLRegLabelIndex", 1)),
                int(age_table)}
        cols |= set(s.get("SAPLabelIndices") or [])
        cols |= set(sap_age)
        return sorted(cols)


# ---------------------------------------------------------------------------
# the checks (each: Ctx -> yields report lines)
# ---------------------------------------------------------------------------

def check_data_source(ctx):
    ok = os.path.isdir(ctx.data_source)
    yield f"[data] DataSource {'ok' if ok else 'missing'}: {ctx.data_source}"


def check_splits(ctx):
    from msd_tpu_torch.data.splits import get_instance_filenames

    for name, key in (("train", "TrainSplit"), ("test", "TestSplit"), ("val", None)):
        path = ctx.specs.get(key) if key else (
            ctx.specs.get("ValSplit") or ctx.specs.get("ValidationSplit"))
        if path is None:
            continue
        if not os.path.isfile(path):
            yield f"[split] {name} missing: {path}"
            continue
        with open(path, encoding="utf-8") as f:
            split_list = json.load(f)
        npyfiles = get_instance_filenames(ctx.data_source, split_list)
        if ctx.max_samples > 0:
            npyfiles = npyfiles[: ctx.max_samples]
        ctx.split_npy[name] = npyfiles
        ctx.split_ids[name] = {
            os.path.splitext(os.path.basename(p))[0] for p in npyfiles
        }
        missing = sum(1 for p in npyfiles if not os.path.isfile(p))
        line = f"[split] {name} count={len(npyfiles)} path={path}"
        if missing:
            line += f" missing_npz={missing}"
        yield line


def check_split_overlap(ctx):
    names = list(ctx.split_ids)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            overlap = len(ctx.split_ids[a] & ctx.split_ids[b])
            yield f"[split] {a}∩{b} overlap={overlap}"


def _column_stats(label_map, npyfiles, col):
    """Stats of one label column over a split, counting missing ids and
    too-short label vectors; -1 and non-finite count as invalid (the
    trainers' missing-label sentinels)."""
    values, missing, bad_index = [], 0, 0
    for p in npyfiles:
        label = label_map.get(os.path.splitext(os.path.basename(p))[0])
        if label is None:
            missing += 1
            continue
        flat = np.asarray(label).reshape(-1)
        if col >= flat.size:
            bad_index += 1
            continue
        values.append(float(flat[col]))
    valid = np.asarray([v for v in values if math.isfinite(v) and v != -1], float)
    return values, valid, missing, bad_index


def check_labels(ctx):
    from msd_tpu_torch.data.labels import load_labels

    cols = ctx.label_indices()
    for key in ("LabelsFile", "PseudoLabelsFile", "RealLabelsFile",
                "SAPCORRLabelsFile", "SAPAgeCORRLabelsFile"):
        value = ctx.specs.get(key)
        if value is None:
            continue
        path = ctx.label_path(value)
        try:
            label_map = load_labels(path)
        except Exception as exc:
            yield f"[labels] {key} error: {exc}"
            continue
        yield f"[labels] {key} path={path}"
        for split, npyfiles in ctx.split_npy.items():
            n_missing = sum(
                1 for p in npyfiles
                if os.path.splitext(os.path.basename(p))[0] not in label_map
            )
            yield f"[labels] {key} split={split} missing={n_missing} total={len(npyfiles)}"
            for col in cols:
                values, valid, missing, bad_index = _column_stats(label_map, npyfiles, col)
                prefix = f"[labels] {key} split={split} idx={col}"
                if valid.size:
                    yield (f"{prefix} count={len(values)} valid={valid.size} "
                           f"min={valid.min():.4f} max={valid.max():.4f} "
                           f"mean={valid.mean():.4f} std={valid.std():.4f} "
                           f"missing_or_invalid={len(values) - valid.size}")
                else:
                    yield f"{prefix} count={len(values)} valid=0 (no finite values)"
                if missing or bad_index:
                    yield f"{prefix} missing_labels={missing} bad_index={bad_index}"


def check_latent_files(ctx):
    expected_dim = int(ctx.specs.get("CodeLength", 0))
    table = (
        ("train", ctx.spec_path("PretrainedLatentPath", "LatentCodesPath")),
        ("test", ctx.spec_path("TestLatentPath")),
        ("val", ctx.spec_path("ValLatentPath")),
    )
    for split, path in table:
        if split not in ctx.split_ids:
            continue
        if path is None:
            yield f"[latents] {split}: path missing"
            continue
        if not os.path.isfile(path):
            yield f"[latents] {split}: file not found: {path}"
            continue
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        codes = data.get("latent_codes") if isinstance(data, dict) else None
        if isinstance(codes, dict) and "weight" in codes:
            shape = tuple(codes["weight"].shape)
            yield (f"[latents] {split}: embedding table shape={shape} "
                   f"expected_dim={expected_dim} dim_ok={shape[-1] == expected_dim}")
        elif isinstance(data, dict):
            # id -> tensor map: coverage vs the split + sampled dims
            ids = ctx.split_ids[split]
            dims = {int(np.asarray(v).reshape(-1).size) for v in list(data.values())[:10]}
            yield (f"[latents] {split}: total={len(data)} "
                   f"missing={len([i for i in ids if i not in data])} "
                   f"extra={len([k for k in data if k not in ids])} "
                   f"dims_sample={sorted(dims)} expected_dim={expected_dim} "
                   f"dim_ok={expected_dim in dims}")
        else:
            yield f"[latents] {split}: not a dict: {path}"


def check_pretrained_decoder(ctx):
    path = ctx.spec_path("PretrainedSDFDecoderPath", "PretrainedDecoderPath")
    if path is not None:
        yield f"[decoder] {'ok' if os.path.isfile(path) else 'missing'}: {path}"


CHECKS = (
    check_data_source,
    check_splits,
    check_split_overlap,
    check_labels,
    check_latent_files,
    check_pretrained_decoder,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Check experiment specs inputs/labels.")
    parser.add_argument("--experiment", "-e", required=True)
    parser.add_argument("--max_samples", type=int, default=0)
    args = parser.parse_args(argv)

    ctx = Ctx(args.experiment, args.max_samples)
    for check in CHECKS:
        for line in check(ctx):
            print(line)


if __name__ == "__main__":
    main()
