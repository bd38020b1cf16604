"""msd_tpu_torch.explorer and ``python -m msd_tpu_torch.latent_explorer``
against msd_tpu's explorer on the same weights, on the CPU.

The sweep's frames are the port's ``create_mesh`` of their latents bit for
bit. Against msd_tpu's frames they are held as tests/test_torch_tooling.py
holds ``generate_training_meshes``: the same vertex and face counts, every
vertex within 1e-4 of the other package's mesh or on a voxel edge along
which the two packages' float32 fields (``FIELD_GAP`` apart) move a vertex
that far. Bit for bit they cannot be: the two packages' float32 decoders
give the same points values up to 2e-6 apart, which moves vertices (here by
up to 2.9e-5) and, where a lattice value sits that close to zero, changes
the triangulation locally (one frame at N=97: the same counts, vertices
within 1.6e-5, another vertex order). The HTML is msd_tpu's byte for byte
when both packages are handed the same frames.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import msd_tpu_torch.workspace as ws  # noqa: E402
from msd_tpu import explorer as jax_explorer  # noqa: E402
from msd_tpu_torch import explorer, latent_explorer  # noqa: E402
from msd_tpu_torch import mesh as mesh_mod  # noqa: E402
from msd_tpu_torch.utils.checkpoint import save_latent_vectors, save_model  # noqa: E402
from test_torch_decoder import CONFIGS, LATENT, make_pair  # noqa: E402
from test_torch_tooling import assert_far_vertices_on_flat_edges  # noqa: E402

DIMS, STEPS, DELTA = [0, 3], 3, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as tests/test_torch_streaming_mesh.py: beside the
    other test workers torch's threads oversubscribe the cores (102
    worker-seconds for this file in a 6-worker run, about 35 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jdec, params, tdec = make_pair(CONFIGS[1], seed=21, surface=True)
    latent = (0.05 * np.random.default_rng(22).standard_normal(LATENT)).astype(np.float32)
    return jdec, jax.tree.map(jnp.asarray, params), tdec, latent


@pytest.fixture(scope="module", params=[49, 97], ids=["dense49", "sparse97"])
def sweeps(request, pair):
    """Both packages' sweeps of the same latent; N=49 takes the dense route
    and N=97 the float32 sparse one (``_pick_block``; the card streams it)."""
    jdec, params, tdec, latent = pair
    N = request.param
    assert (mesh_mod._pick_block(N, 0.1, 1.3) == 4) == (N == 97)
    ours = explorer.sweep_frames(tdec, latent, DIMS, STEPS, DELTA, N)
    ref = jax_explorer.sweep_frames(jdec, params, latent, DIMS, STEPS, DELTA, N)
    return N, ours, ref


def frame_latents(latent):
    """(dim, step, latent) of every sweep frame, as sweep_frames builds them."""
    for d in DIMS:
        for i, s in enumerate(np.linspace(-DELTA, DELTA, STEPS)):
            z = latent.copy()
            z[d] += s
            yield d, i, z


def test_sweep_frames_match_jax(pair, sweeps):
    _, _, tdec, latent = pair
    N, (base, frames, steps), (rbase, rframes, rsteps) = sweeps
    np.testing.assert_array_equal(steps, rsteps)
    assert sorted(frames) == sorted(rframes) == DIMS
    meshes = [(latent, base, rbase)] + [(z, frames[d][i], rframes[d][i]) for d, i, z in frame_latents(latent)]
    for z, ours, theirs in meshes:
        assert ours is not None and theirs is not None
        (v, f), (rv, rf) = ours, theirs
        assert v.shape == rv.shape and f.shape == rf.shape and v.shape[0] > 100
        assert_far_vertices_on_flat_edges(tdec, z, v, rv, N)
        assert_far_vertices_on_flat_edges(tdec, z, rv, v, N)
    # the centre step is the base mesh itself, as msd_tpu's
    assert all(frames[d][STEPS // 2] is base for d in DIMS)


def test_sweep_frames_are_create_mesh(pair, sweeps, monkeypatch):
    """Every frame is ``create_mesh(decoder, latent, N=N)`` bit for bit, and
    the sweep builds one ``PointEvaluator`` for all its frames."""
    _, _, tdec, latent = pair
    N, (base, frames, _), _ = sweeps
    for d, i, z in frame_latents(latent):
        v, f = mesh_mod.create_mesh(tdec, torch.from_numpy(z), N=N, return_mesh=True)
        np.testing.assert_array_equal(frames[d][i][0], v)
        np.testing.assert_array_equal(frames[d][i][1], f)
    built = []
    real = mesh_mod.PointEvaluator

    def counted(*args, **kw):
        built.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(mesh_mod, "PointEvaluator", counted)
    again = explorer.sweep_frames(tdec, latent, [1], 2, DELTA, 33)
    assert len(built) == 1 and len(again[1][1]) == 2


def test_pack_mesh_matches_jax(sweeps):
    _, (base, _, _), _ = sweeps
    assert explorer._pack_mesh(base) == jax_explorer._pack_mesh(base)
    assert explorer._pack_mesh(None) is jax_explorer._pack_mesh(None) is None


def test_html_byte_for_byte(pair, sweeps, tmp_path, monkeypatch):
    """Handed the same frames, msd_tpu's ``export_interactive_html`` and the
    port's write the same bytes, with a given title and the default one."""
    jdec, params, tdec, latent = pair
    N, ours, _ = sweeps
    monkeypatch.setattr(jax_explorer, "sweep_frames", lambda *args: ours)
    for kw in ({"title": "shape explorer"}, {}):
        a = explorer.export_interactive_html(tdec, latent, str(tmp_path / "ours.html"), dims=DIMS, steps=STEPS,
                                             delta=DELTA, N=N, **kw)
        b = jax_explorer.export_interactive_html(jdec, params, latent, str(tmp_path / "ref.html"), dims=DIMS,
                                                 steps=STEPS, delta=DELTA, N=N, **kw)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_html_without_surface_raises(pair, tmp_path):
    _, _, tdec, latent = pair
    with torch.no_grad():
        shifted = type(tdec)(LATENT, **CONFIGS[1])
        shifted.load_state_dict(tdec.state_dict())
        list(shifted.parameters())[-1].add_(5.0)  # the last bias: the field stays positive
    with pytest.raises(RuntimeError, match="no sweep frame produced a surface"):
        explorer.export_interactive_html(shifted.eval(), latent, str(tmp_path / "x.html"), dims=[0], steps=2, N=17)


@pytest.fixture(scope="module")
def experiment(pair, tmp_path_factory):
    """An experiment with the pair's decoder as epoch 3 and 3 latents."""
    _, _, tdec, latent = pair
    exp = str(tmp_path_factory.mktemp("explorer") / "exp")
    ws.save_experiment_specifications(exp, {"NetworkArch": "deep_sdf_decoder", "CodeLength": LATENT,
                                            "NetworkSpecs": CONFIGS[1]})
    save_model(exp, "latest.pth", tdec, 3)
    table = np.stack([latent, 0.8 * latent, latent[::-1].copy()])
    save_latent_vectors(exp, "latest.pth", torch.from_numpy(table), 3)
    return exp, table


def payload(path):
    with open(path, encoding="utf-8") as f:
        html = f.read()
    return json.loads(re.search(r"const DATA = (\{.*\});\n", html).group(1))


def test_latent_explorer_html(experiment, monkeypatch):
    """``--mode html``: msd_tpu's title and file name, ``-N`` capped at 97,
    every frame of the payload ``_pack_mesh`` of ``create_mesh`` of its
    latent; and the mode runs with matplotlib unimportable."""
    exp, table = experiment
    for name in ("matplotlib", "matplotlib.pyplot", "msd_tpu_torch.plotting"):
        monkeypatch.setitem(sys.modules, name, None)
    out = latent_explorer.main(["-e", exp, "--mode", "html", "--dims", "1", "--steps", "3", "-N", "129",
                                "--shape_a", "1", "--device", "cpu", "--quiet"])
    assert out == os.path.join(exp, "latent_explorer_epoch3.html")
    data = payload(out)
    assert data["title"] == "exp epoch 3 latent explorer" and data["dims"] == [1]
    assert data["steps"] == [-0.05, 0.0, 0.05]
    ev = mesh_mod.PointEvaluator(ws.load_decoder(exp, "latest")[0])
    for i, s in enumerate(data["steps"]):
        z = table[1].copy()
        z[1] += np.float64(s)  # sweep_frames adds linspace's float64 offsets to the float32 latent
        want = explorer._pack_mesh(mesh_mod.create_mesh(ev.decoder, torch.from_numpy(z), N=97, return_mesh=True,
                                                        evaluator=ev))
        assert data["frames"]["1"][i] == want
    assert data["base"] == data["frames"]["1"][1]


@pytest.mark.parametrize("mode", ["interp", "sweep"])
def test_latent_explorer_figures(experiment, mode):
    exp, _ = experiment
    out = latent_explorer.main(["-e", exp, "--mode", mode, "--steps", "2", "-N", "33", "--dim", "2",
                                "--device", "cpu", "--quiet"])
    name = "latent_interp_0_1_epoch3.png" if mode == "interp" else "latent_sweep_shape0_dim2_epoch3.png"
    assert out == os.path.join(exp, name) and os.path.getsize(out) > 1000
    import matplotlib.pyplot as plt

    plt.close("all")


def test_latent_explorer_live(experiment, monkeypatch):
    """``--mode live`` on a non-interactive backend with ``plt.show``
    patched: a 3-D view of the base shape and one slider per dim; moving a
    slider decodes the new latent."""
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    exp, _ = experiment
    shown, sliders = [], []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    real_init = Slider.__init__

    def keep(self, *args, **kw):
        real_init(self, *args, **kw)
        sliders.append(self)

    monkeypatch.setattr(Slider, "__init__", keep)
    assert latent_explorer.main(["-e", exp, "--mode", "live", "--dims", "0", "2", "-N", "33",
                                 "--device", "cpu", "--quiet"]) is None
    fig = shown[0]
    assert len(sliders) == 2 and fig.axes[0].get_title() == "latent explorer"
    n_polys = len(fig.axes[0].collections[0].get_paths())
    sliders[1].set_val(sliders[1].valmax)
    assert fig.axes[0].get_title() == "latent explorer"
    assert len(fig.axes[0].collections[0].get_paths()) != n_polys
    plt.close("all")


def test_latent_explorer_cuda_without_gpu_raises(experiment):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        latent_explorer.main(["-e", experiment[0], "--mode", "html", "--quiet"])
