"""Create a labels.pt file from a metadata CSV — script equivalent of the
reference's utils/label_creation.ipynb.

The CSV must have an id column (matching SdfSamples basenames) plus one or
more label columns (e.g. diagnosis, age). Continuous columns can be min-max
normalized to [0, 1] (the convention the Stage-2 losses expect for age).

    python -m msd_tpu_torch.utils.label_creation --csv <csv> --columns <c ...> --out <labels.pt>

Counterpart of the root ``utils/label_creation.py``.
"""

import argparse
import csv
import os

import numpy as np

from msd_tpu_torch.data.labels import save_labels


def main():
    parser = argparse.ArgumentParser(description="CSV -> labels.pt")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--id_column", default="id")
    parser.add_argument("--columns", nargs="+", required=True, help="label columns, in order")
    parser.add_argument("--normalize", nargs="*", default=[], help="columns to min-max normalize to [0,1]")
    parser.add_argument("--out", required=True, help="output labels file (.pt/.npz/.json)")
    args = parser.parse_args()

    with open(args.csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise SystemExit("empty CSV")

    values = {c: [] for c in args.columns}
    ids = []
    for row in rows:
        ids.append(str(row[args.id_column]))
        for c in args.columns:
            raw = row.get(c, "")
            try:
                values[c].append(float(raw))
            except (TypeError, ValueError):
                values[c].append(float("nan"))

    arrays = {}
    for c in args.columns:
        arr = np.asarray(values[c], np.float64)
        if c in args.normalize:
            finite = arr[np.isfinite(arr)]
            if finite.size and finite.max() > finite.min():
                arr = (arr - finite.min()) / (finite.max() - finite.min())
        arrays[c] = arr

    label_map = {
        iid: np.asarray([arrays[c][i] for c in args.columns], np.float32)
        for i, iid in enumerate(ids)
    }
    save_labels(args.out, label_map)
    print(f"wrote {len(label_map)} labels ({args.columns}) to {args.out}")
    for c in args.columns:
        arr = arrays[c]
        finite = arr[np.isfinite(arr)]
        print(f"  {c}: valid={finite.size}/{arr.size} min={finite.min():.4f} max={finite.max():.4f}")


if __name__ == "__main__":
    main()
