"""Latent-space shape explorer (counterpart of the root
``latent_explorer.py``, the reference's
interactive_visualization_latent_to_shape.ipynb).

``python -m msd_tpu_torch.latent_explorer -e <exp> [-c latest] --mode
{interp,sweep,html,live} ...`` takes the root script's flags plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU, and asking for
``cuda`` without a GPU raises). Every mesh goes through ``create_mesh``, so
K1 on the card.

Modes:
- ``interp`` / ``sweep``: batch figure (latent interpolation / single-dim
  sweep rendered to a PNG strip); needs matplotlib.
- ``html``: **interactive**: exports a self-contained HTML explorer with
  one slider per latent dim over precomputed marching-cubes frames
  (drag-rotate canvas viewer; no network or dependencies); needs no
  matplotlib:

      python -m msd_tpu_torch.latent_explorer -e <exp> --mode html --dims 0 1 2 3

- ``live``: matplotlib-widget sliders decoding through the real decoder on
  every change (notebook parity; requires a display).

``plotting`` is imported only in ``interp``/``sweep`` and ``explorer`` only
in ``html``/``live`` (the root script imports ``plotting`` at the top), so
that ``--mode html`` runs where matplotlib is not installed.
"""

from __future__ import annotations

import argparse
import os

import msd_tpu_torch.workspace as ws
from msd_tpu_torch.device import resolve_device
from msd_tpu_torch.utils import add_common_args, configure_logging


def main(argv=None):
    """Runs the CLI on ``argv``; returns the path of the file written (None
    in ``live`` mode)."""
    parser = argparse.ArgumentParser(description="Explore the latent space of a trained decoder")
    parser.add_argument("--experiment", "-e", required=True)
    parser.add_argument("--checkpoint", "-c", default="latest")
    parser.add_argument("--mode", choices=["interp", "sweep", "html", "live"], default="interp")
    parser.add_argument("--shape_a", type=int, default=0)
    parser.add_argument("--shape_b", type=int, default=1)
    parser.add_argument("--dim", type=int, default=0, help="latent dim for sweep mode")
    parser.add_argument("--dims", type=int, nargs="*", default=None,
                        help="latent dims to expose as sliders (html/live modes)")
    parser.add_argument("--delta", type=float, default=0.05, help="sweep range +-delta")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--resolution", "-N", type=int, default=129)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_common_args(parser)
    args = parser.parse_args(argv)
    configure_logging(args)

    dev = resolve_device(args.device)
    decoder, epoch = ws.load_decoder(args.experiment, args.checkpoint)
    decoder = decoder.to(dev).eval()
    latents = ws.load_latent_vectors(args.experiment, args.checkpoint)

    if args.mode in ("html", "live"):
        from msd_tpu_torch import explorer

        base = latents[args.shape_a]
        if args.mode == "html":
            out = args.out or os.path.join(
                args.experiment, f"latent_explorer_epoch{epoch}.html"
            )
            steps = args.steps if args.steps > 1 else 9
            explorer.export_interactive_html(
                decoder, base, out, dims=args.dims, steps=steps,
                delta=args.delta, N=min(args.resolution, 97),
                title=f"{os.path.basename(os.path.normpath(args.experiment))} "
                      f"epoch {epoch} latent explorer",
            )
            print(f"saved {out} — open in any browser")
            return out
        explorer.run_matplotlib_explorer(
            decoder, base, dims=args.dims,
            delta=args.delta, N=min(args.resolution, 64),
        )
        return None

    from msd_tpu_torch import plotting

    if args.mode == "interp":
        lat_a, lat_b = latents[args.shape_a], latents[args.shape_b]
        title = f"interp_{args.shape_a}_{args.shape_b}"
    else:
        lat_a = latents[args.shape_a].copy()
        lat_b = lat_a.copy()
        lat_a[args.dim] -= args.delta
        lat_b[args.dim] += args.delta
        title = f"sweep_shape{args.shape_a}_dim{args.dim}"

    fig = plotting.plot_lat_interpolation(
        decoder, lat_a, lat_b, steps=args.steps, N=args.resolution
    )
    out = args.out or os.path.join(args.experiment, f"latent_{title}_epoch{epoch}.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
