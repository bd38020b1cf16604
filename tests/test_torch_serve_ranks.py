"""The port's serving over ranks on the CPU (gloo): ``reconstruct_batch``
and ``PointEvaluator`` over a group against one process, the reconstruct
CLI's ``--batch`` over 2 ranks against one process, and the kNN sign vote
sharded over several devices of one process against one device. This
module imports no JAX: the ranks are spawned processes that import it
again (tests/test_torch_serve_ranks_jax.py holds the comparisons with
msd_tpu and reuses the rank functions here)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from chip_smoke import write_dataset
from msd_tpu_torch import mesh
from msd_tpu_torch import reconstruct as reconstruct_cli
from msd_tpu_torch.data.mesh_io import load_ply
from msd_tpu_torch.models import build_decoder
from msd_tpu_torch.models.deepsdf import give_surface_
from msd_tpu_torch.parallel import init_group_from_env, run_ranks
from msd_tpu_torch.preprocess import mesh_to_sdf as tm
from msd_tpu_torch.train.reconstruct import reconstruct_batch
from msd_tpu_torch.utils.checkpoint import save_model
from test_torch_dp import TIMEOUT, cpus

LATENT = 16
NET = dict(dims=[32] * 4, dropout=[], dropout_prob=0.0, norm_layers=[], latent_in=[2], xyz_in_all=False,
           use_tanh=False, latent_dropout=False, weight_norm=True)
FIT = dict(num_samples=512, lr=5e-3, l2reg=True, seed=7, return_loss_hist=True)
ITERS = 40
N_POINTS = 1000  # not a multiple of 3
MESH_N = 33


def seeded_decoder(seed=3):
    """A seeded decoder at the tests' width, given a surface (``give_surface_``)."""
    dec = build_decoder("deep_sdf_decoder", LATENT, NET, generator=torch.Generator().manual_seed(seed))
    give_surface_(dec, torch.zeros(LATENT))
    return dec.eval()


def sphere_shapes(n, samples=600, seed=0):
    """``n`` (pos, neg) [samples, 4] arrays of spheres of growing radius."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        radius = 0.35 + 0.08 * i
        d = rng.standard_normal((2 * samples, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        r = radius + rng.uniform(-0.15, 0.15, 2 * samples)
        s = np.concatenate([d * r[:, None], (r - radius)[:, None]], axis=1).astype(np.float32)
        out.append((s[s[:, 3] > 0][:samples], s[s[:, 3] <= 0][:samples]))
    return out


def serve_rank(group, decoder, shapes, iters, fit, latent, pts, mesh_n, out_dir):
    """On each rank: ``reconstruct_batch(group=)`` of ``shapes``, then
    ``PointEvaluator(group=)`` on ``pts`` and ``create_mesh`` through it
    (written as ``<out_dir>/rank<r>``). Returns numpy results and this
    rank's share of the points."""
    losses, latents = reconstruct_batch(decoder, iters, LATENT, shapes, 0.01, 0.1, group=group, **fit)
    ev = mesh.PointEvaluator(decoder, group=group)
    vals = ev.eval_points(latent, pts).numpy()
    n_points = ev.n_evaluated
    verts, faces = mesh.create_mesh(decoder, latent, os.path.join(out_dir, f"rank{group.rank}"), N=mesh_n,
                                    return_mesh=True, evaluator=ev)
    return {"losses": losses, "latents": latents.numpy(), "part": group.row_slice(len(shapes)), "vals": vals,
            "n_points": n_points, "n_evaluated": ev.n_evaluated, "verts": verts, "faces": faces}


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """One spawn of 3 ranks for the fit and evaluator tests, and the inputs."""
    out_dir = str(tmp_path_factory.mktemp("serve_ranks"))
    decoder, shapes = seeded_decoder(), sphere_shapes(4)
    rng = np.random.default_rng(5)
    latent = (0.05 * rng.standard_normal(LATENT)).astype(np.float32)
    pts = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    ranks = run_ranks(serve_rank, 3, (decoder, shapes, ITERS, FIT, latent, pts, MESH_N, out_dir), devices=cpus(3),
                      timeout=TIMEOUT)
    return decoder, shapes, latent, pts, out_dir, ranks


def test_reconstruct_batch_on_3_ranks(three_ranks):
    """4 shapes over 3 ranks (2, 2 and none): each rank's shapes bit for bit
    as one process fitting that slice with ``seed + start``; all 4 within
    1e-5 of one process fitting all 4; every rank returns the same arrays."""
    decoder, shapes, _, _, _, ranks = three_ranks
    assert [r["part"] for r in ranks] == [slice(0, 2), slice(2, 4), slice(4, 4)]
    for r in ranks:
        assert r["losses"].shape == (4, ITERS) and r["latents"].shape == (4, LATENT)
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        np.testing.assert_array_equal(r["latents"], ranks[0]["latents"])
        part = r["part"]
        if part.stop > part.start:
            hist, lat = reconstruct_batch(decoder, ITERS, LATENT, shapes[part], 0.01, 0.1,
                                          **dict(FIT, seed=FIT["seed"] + part.start))
            np.testing.assert_array_equal(r["latents"][part], lat.numpy())
            np.testing.assert_array_equal(r["losses"][part], hist)
    hist, lat = reconstruct_batch(decoder, ITERS, LATENT, shapes, 0.01, 0.1, **FIT)
    np.testing.assert_allclose(ranks[0]["latents"], lat.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["losses"], hist, rtol=1e-5, atol=1e-5)
    assert np.isfinite(hist).all() and np.all(hist[:, -1] < hist[:, 0])


def test_point_evaluator_on_3_ranks(three_ranks):
    """1000 points over 3 ranks (334, 334, 332): every rank holds every value,
    within 1e-6 of one process (CPU BLAS may block rows differently); each
    rank counts its own points."""
    decoder, _, latent, pts, _, ranks = three_ranks
    ref = mesh.PointEvaluator(decoder).eval_points(latent, pts).numpy()
    assert [r["n_points"] for r in ranks] == [334, 334, 332]
    for r in ranks:
        np.testing.assert_array_equal(r["vals"], ranks[0]["vals"])
    np.testing.assert_allclose(ranks[0]["vals"], ref, rtol=0, atol=1e-6)


def test_create_mesh_on_3_ranks(three_ranks):
    """create_mesh through the evaluator over ranks: one process's face
    count, vertices within 1e-5, every rank returns the mesh, only rank 0
    writes its .ply, and the ranks' points add up to one process's."""
    decoder, _, latent, _, out_dir, ranks = three_ranks
    ev = mesh.PointEvaluator(decoder)
    verts, faces = mesh.create_mesh(decoder, latent, None, N=MESH_N, return_mesh=True, evaluator=ev)
    for r in ranks:
        assert r["faces"].shape == faces.shape and r["verts"].shape == verts.shape
        np.testing.assert_allclose(r["verts"], verts, atol=1e-5)
    assert sum(r["n_evaluated"] - r["n_points"] for r in ranks) == ev.n_evaluated
    assert sorted(os.listdir(out_dir)) == ["rank0.ply"]
    pv, pf = load_ply(os.path.join(out_dir, "rank0.ply"))
    np.testing.assert_array_equal(pv, ranks[0]["verts"])
    np.testing.assert_array_equal(pf, ranks[0]["faces"])


def write_experiment(root, decoder, n_shapes=4):
    """An experiment holding ``decoder`` as epoch 5 and ``n_shapes`` seeded
    ellipsoids; returns (experiment, SdfSamples directory, split path)."""
    exp, data = os.path.join(root, "exp"), os.path.join(root, "data")
    os.makedirs(exp)
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump({"NetworkArch": "deep_sdf_decoder", "CodeLength": LATENT, "NetworkSpecs": NET}, f)
    save_model(exp, "latest.pth", decoder, 5)
    split = write_dataset(data, n_shapes, 4000, seed=9)
    split_path = os.path.join(root, "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    return exp, os.path.join(data, "SdfSamples"), split_path


def cli_argv(exp, data, split_path, *extra):
    return ["-e", exp, "-c", "latest", "-d", data, "-s", split_path, "--iters", "20", "--mesh_resolution",
            str(MESH_N), "--device", "cpu", "--quiet", *extra]


def cli_rank(group, argv, shuffle_seed):
    """The reconstruct CLI on this rank (``main(argv, group=)``), the split
    shuffled from ``shuffle_seed`` (the main rank's order is every rank's)."""
    random.seed(shuffle_seed + group.rank)
    return reconstruct_cli.main(argv, group=group)


def cli_outputs(exp):
    """{shape: (code, verts, faces)} of an experiment's Reconstructions/5."""
    out = os.path.join(exp, "Reconstructions", "5")
    names = sorted(n[:-4] for n in os.listdir(os.path.join(out, "Codes")))
    return {n: (torch.load(os.path.join(out, "Codes", n + ".pth")).numpy(),
                *load_ply(os.path.join(out, "Meshes", n + ".ply"))) for n in names}


def test_reconstruct_cli_batch_on_2_ranks(tmp_path):
    """``--batch 4`` on 2 ranks writes what one process writes: the same
    shapes, codes within 1e-5, meshes with the same faces and vertices
    within 1e-5; only the main rank writes and returns the summary."""
    decoder = seeded_decoder(4)
    exp, data, split_path = write_experiment(str(tmp_path / "ranks"), decoder)
    one_exp, one_data, one_split = write_experiment(str(tmp_path / "one"), decoder)
    ranks = run_ranks(cli_rank, 2, (cli_argv(exp, data, split_path, "--batch", "4"), 11), devices=cpus(2),
                      timeout=TIMEOUT)
    assert len(ranks[0]) == 4 and ranks[1] == []
    random.seed(11)
    one = reconstruct_cli.main(cli_argv(one_exp, one_data, one_split, "--batch", "4"))
    assert [s["shape"] for s in ranks[0]] == [s["shape"] for s in one]
    ours, ref = cli_outputs(exp), cli_outputs(one_exp)
    assert sorted(ours) == sorted(ref) and len(ref) == 4
    for name, (code, verts, faces) in ref.items():
        np.testing.assert_allclose(ours[name][0], code, rtol=1e-5, atol=1e-5, err_msg=name)
        assert ours[name][2].shape == faces.shape, name
        np.testing.assert_allclose(ours[name][1], verts, atol=1e-5, err_msg=name)


def test_reconstruct_cli_one_at_a_time_refuses_a_group(tmp_path):
    exp, data, split_path = write_experiment(str(tmp_path), seeded_decoder(), n_shapes=1)

    class Group:  # refused before the group is used
        world_size, rank, is_main, device = 2, 0, True, torch.device("cpu")

    with pytest.raises(ValueError, match="--batch"):
        reconstruct_cli.main(cli_argv(exp, data, split_path), group=Group())
    assert not os.path.exists(os.path.join(exp, "Reconstructions"))


def test_group_from_env_on_cuda_without_gpu_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_group_from_env("cuda")


def sphere_vote_inputs(n_queries=5000, n_surface=3000, seed=0):
    """Queries in [-0.9, 0.9]^3 and oriented surface points of a sphere of
    radius 0.6 with slightly jittered normals."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_surface, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    norms = d + 0.05 * rng.standard_normal(d.shape)
    norms /= np.linalg.norm(norms, axis=1, keepdims=True)
    q = rng.uniform(-0.9, 0.9, (n_queries, 3)).astype(np.float32)
    return q, (0.6 * d).astype(np.float32), norms.astype(np.float32)


def test_knn_sign_vote_on_3_devices_byte_identical():
    """The tiled vote over 3 devices (query chunks of 512: 10 chunks, the
    last ragged, in 4 rounds) gives the one-device vote's bytes."""
    q, s, n = sphere_vote_inputs()
    kw = dict(num_votes=11, q_chunk=512, force_device=True)
    sdf1, keep1 = tm.knn_sign_vote(q, s, n, devices=["cpu"], **kw)
    sdf3, keep3 = tm.knn_sign_vote(q, s, n, devices=["cpu"] * 3, **kw)
    sdf0, keep0 = tm.knn_sign_vote(q, s, n, device="cpu", **kw)
    assert sdf1.tobytes() == sdf3.tobytes() == sdf0.tobytes()
    np.testing.assert_array_equal(keep1, keep3)
    np.testing.assert_array_equal(keep1, keep0)
    assert 0 < keep3.sum() < len(q) and (sdf3 < 0).any() and (sdf3 > 0).any()


def test_preprocess_mesh_on_2_devices_byte_identical():
    """preprocess_mesh with the vote over 2 devices writes the one-device
    {pos, neg} bytes; a device list that is not one kind, or CUDA without
    a GPU, raises."""
    from chip_smoke import ellipsoid_mesh

    v, f = ellipsoid_mesh(np.array([0.5, 0.4, 0.3]))
    kw = dict(num_samples=20000, surface_vote_points=6000, seed=3, knn_force_device=True, visibility="watertight")
    pos1, neg1, info1 = tm.preprocess_mesh(v, f, knn_devices=["cpu"], **kw)
    pos2, neg2, info2 = tm.preprocess_mesh(v, f, knn_devices=["cpu", "cpu"], **kw)
    assert pos1.tobytes() == pos2.tobytes() and neg1.tobytes() == neg2.tobytes()
    assert len(pos1) > 0 and len(neg1) > 0
    assert info1["vote"]["chunks"] == info2["vote"]["chunks"] == 3
    assert info2["vote"]["device"] == ["cpu", "cpu"]
    q, s, n = sphere_vote_inputs(100, 100)
    with pytest.raises(ValueError, match="not both"):
        tm.knn_sign_vote(q, s, n, devices=["cpu", "cuda:0"], force_device=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.knn_sign_vote(q, s, n, devices=["cuda:0", "cuda:0"])
