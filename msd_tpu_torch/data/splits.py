"""Split JSON handling (counterpart of ``msd_tpu/data/splits.py``).

Reference splits are flat JSON lists of ``<id>.obj`` filenames
(ref: examples/splits/*; deep_sdf/data.py:18-35 maps entries to .npz paths).
Older DeepSDF-style nested splits ({dataset: {class: [ids]}}) are also
accepted because workspace path helpers use (dataset, class, instance)
triples.
"""

from __future__ import annotations

import logging
import os
from typing import List, Tuple


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
