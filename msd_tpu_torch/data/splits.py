"""Split JSON handling (counterpart of ``msd_tpu/data/splits.py``).

Reference splits are flat JSON lists of ``<id>.obj`` filenames
(ref: examples/splits/*; deep_sdf/data.py:18-35 maps entries to .npz paths).
Older DeepSDF-style nested splits ({dataset: {class: [ids]}}) are also
accepted because workspace path helpers use (dataset, class, instance)
triples.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import List, Sequence, Tuple


def load_split(split_filename: str):
    with open(split_filename) as f:
        return json.load(f)


def split_instance_ids(split) -> List[str]:
    """Flatten a split (flat list or nested dict) into instance ids without
    extensions."""
    return [t[2] for t in split_triples(split)]


def split_triples(split) -> List[Tuple[str, str, str]]:
    """(dataset, class, instance) triples for nested splits; flat splits get
    empty dataset/class components."""
    if isinstance(split, list):
        return [("", "", os.path.splitext(name)[0]) for name in split]
    triples = []
    for dataset, classes in split.items():
        for class_name, instances in classes.items():
            triples.extend(
                (dataset, class_name, os.path.splitext(i)[0]) for i in instances
            )
    return triples


def get_instance_filenames(data_source: str, split) -> List[str]:
    """Map split entries to .npz sample paths, warning on missing files
    (ref: deep_sdf/data.py:18-35)."""
    npzfiles = []
    for dataset, class_name, instance in split_triples(split):
        rel = os.path.join(dataset, class_name, instance + ".npz")
        filename = os.path.join(data_source, rel) if (dataset or class_name) else os.path.join(
            data_source, instance + ".npz"
        )
        if not os.path.isfile(filename):
            logging.warning("Requested non-existent file '%s'", filename)
        npzfiles.append(filename)
    return npzfiles


def create_split_files(
    mesh_filenames: Sequence[str],
    out_dir: str,
    prefix: str,
    fractions=(0.8, 0.1, 0.1),
    seed: int = 0,
):
    """80/10/10 shuffled split JSONs, flat list of filenames
    (ref: utils/create_split_json_files.py:14-34)."""
    names = sorted(os.path.basename(f) for f in mesh_filenames)
    rng = random.Random(seed)
    rng.shuffle(names)
    n = len(names)
    n_train = int(fractions[0] * n)
    n_val = int(fractions[1] * n)
    splits = {
        "train": names[:n_train],
        "val": names[n_train : n_train + n_val],
        "test": names[n_train + n_val :],
    }
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for k, v in splits.items():
        path = os.path.join(out_dir, f"{prefix}_{k}_split.json")
        with open(path, "w") as f:
            json.dump(v, f, indent=1)
        paths[k] = path
    return paths


def create_subject_split_files(
    mesh_filenames: Sequence[str],
    out_dir: str,
    prefix: str,
    subject_pattern: str = r"ADNI_(\d+_S_\d+)_",
    metadata_csv: str | None = None,
    id_column: str = "subject_id",
    label_column: str = "diagnosis",
    allowed_labels: Sequence[str] | None = None,
    stratify: bool = False,
    fractions=(0.85, 0.10, 0.05),
    seed: int = 42,
):
    """Subject-disjoint train/test/val split JSONs, optionally stratified by
    a metadata label (ref: utils/create_split_json_files_ADNI_hippo.ipynb —
    subjects are extracted from filenames by regex, grouped so every file of
    a subject lands in the same split, optionally filtered to
    ``allowed_labels`` (e.g. CN/AD only, dropping MCI) and stratified by
    diagnosis). ``fractions`` are (train, test, val) in the notebook's order.

    Returns {"train"/"test"/"val": path, "summary": {...}}.
    """
    import re

    names = sorted(os.path.basename(f) for f in mesh_filenames)
    pat = re.compile(subject_pattern)
    subject_to_files: dict = {}
    unmatched = []
    for name in names:
        m = pat.search(name)
        if not m:
            unmatched.append(name)
            continue
        sid = m.group(1) if pat.groups else m.group(0)
        subject_to_files.setdefault(sid, []).append(name)
    if unmatched:
        logging.warning(
            "%d files did not match subject pattern %r (e.g. %s)",
            len(unmatched), subject_pattern, unmatched[0],
        )

    subject_labels: dict = {}
    if metadata_csv is not None:
        import csv

        with open(metadata_csv, newline="") as f:
            for row in csv.DictReader(f):
                sid = (row.get(id_column) or "").strip()
                lab = (row.get(label_column) or "").strip()
                if sid and lab:
                    subject_labels.setdefault(sid, set()).add(lab)
        known = set(subject_labels)
        unknown = [s for s in subject_to_files if s not in known]
        if unknown:
            logging.warning("%d subjects missing from metadata; dropped", len(unknown))
        subject_to_files = {s: v for s, v in subject_to_files.items() if s in known}
        if allowed_labels is not None:
            allowed = set(allowed_labels)
            subject_to_files = {
                s: v for s, v in subject_to_files.items()
                if subject_labels[s].issubset(allowed)
            }

    subjects = sorted(subject_to_files)
    rng = random.Random(seed)

    def assign(subs):
        """Shuffle and cut into train/test/val by ``fractions`` (notebook
        order: train first, then test, the remainder val)."""
        subs = list(subs)
        rng.shuffle(subs)
        n = len(subs)
        n_train = int(n * fractions[0])
        n_test = int(n * fractions[1])
        return subs[:n_train], subs[n_train : n_train + n_test], subs[n_train + n_test :]

    if stratify and subject_labels:
        by_label: dict = {}
        for s in subjects:
            key = ",".join(sorted(subject_labels.get(s, {"?"})))
            by_label.setdefault(key, []).append(s)
        tr, te, va = [], [], []
        for key in sorted(by_label):
            a, b, c = assign(by_label[key])
            tr += a
            te += b
            va += c
    else:
        tr, te, va = assign(subjects)

    def collect(subs):
        files = []
        for s in subs:
            files.extend(subject_to_files[s])
        return sorted(files)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for k, subs in (("train", tr), ("test", te), ("val", va)):
        path = os.path.join(out_dir, f"{prefix}_{k}_split.json")
        with open(path, "w") as f:
            json.dump(collect(subs), f, indent=1)
        paths[k] = path
    paths["summary"] = {
        "subjects": len(subjects),
        "train_subjects": len(tr),
        "test_subjects": len(te),
        "val_subjects": len(va),
        "unmatched_files": len(unmatched),
    }
    return paths
