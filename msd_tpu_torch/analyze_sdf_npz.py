"""Inspect a SdfSamples .npz (counterpart of the root ``analyze_sdf_npz.py``,
the reference's analyze_sdf_npz.ipynb): prints sample statistics and saves
sign-colored scatter + cross-section figures next to the file.

``python -m msd_tpu_torch.analyze_sdf_npz <file.npz> [--max_points 20000]``.
Needs matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from msd_tpu_torch.data.sdf_samples import read_sdf_samples


def main(argv=None):
    """Runs the CLI on ``argv``; returns the two PNGs' paths."""
    from msd_tpu_torch import plotting

    parser = argparse.ArgumentParser(description="Analyze a SdfSamples .npz")
    parser.add_argument("npz")
    parser.add_argument("--max_points", type=int, default=20000)
    args = parser.parse_args(argv)

    pos, neg = read_sdf_samples(args.npz)
    allp = np.concatenate([pos, neg], axis=0)
    print(f"{args.npz}")
    print(f"  pos samples: {len(pos)}   neg samples: {len(neg)}")
    for name, arr in (("pos", pos), ("neg", neg), ("all", allp)):
        sdf = arr[:, 3]
        print(
            f"  {name}: sdf min={sdf.min():.5f} max={sdf.max():.5f} "
            f"mean={sdf.mean():.5f} |sdf|<0.01: {(np.abs(sdf) < 0.01).mean():.1%}"
        )
    bbox_lo = allp[:, :3].min(axis=0)
    bbox_hi = allp[:, :3].max(axis=0)
    print(f"  xyz bbox: {np.round(bbox_lo, 3)} .. {np.round(bbox_hi, 3)}")

    rng = np.random.default_rng(0)
    sel = rng.choice(len(allp), min(args.max_points, len(allp)), replace=False)
    base = os.path.splitext(args.npz)[0]
    fig = plotting.render_sdf(allp[sel, :3], allp[sel, 3])
    fig.savefig(base + "_scatter.png", dpi=120, bbox_inches="tight")
    plotting.plt.close(fig)
    fig = plotting.plot_sdf_cross_section(allp[:, :3], allp[:, 3])
    fig.savefig(base + "_cross_section.png", dpi=120, bbox_inches="tight")
    plotting.plt.close(fig)
    print(f"  figures: {base}_scatter.png, {base}_cross_section.png")
    return base + "_scatter.png", base + "_cross_section.png"


if __name__ == "__main__":
    main()
