"""msd_tpu_torch's data-preparation CLIs against the root scripts on the
same inputs: preprocess_data (SDF, --test, --surface; the port with
--device cpu), run_all_preprocessing, the five utils scripts, and the split
writers."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import msd_tpu.data.splits as jsplits
import msd_tpu_torch.data.splits as tsplits
from conftest import make_sphere_mesh
from msd_tpu_torch.data.labels import load_labels
from msd_tpu_torch.data.mesh_io import load_ply, save_obj, save_ply
from msd_tpu_torch.data.nifti import load_nifti, save_nifti
from msd_tpu_torch.ops.marching_cubes import marching_tetrahedra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}


def _run(argv, cwd):
    r = subprocess.run([sys.executable, *argv], capture_output=True, text=True, env=ENV, cwd=cwd, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


def _root(script, *args, cwd):
    return _run([os.path.join(REPO, script), *args], cwd)


def _port(module, *args, cwd):
    return _run(["-m", module, *args], cwd)


def _tree(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for dirpath, _, names in os.walk(d):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


@pytest.fixture
def meshes(tmp_path):
    """Two OBJ meshes (a watertight ellipsoid from marching tetrahedra, and a
    UV sphere with holes, so "auto" renders it) and a split listing them
    and a missing one."""
    src = tmp_path / "meshes"
    src.mkdir()
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, 24)] * 3, indexing="ij")
    vb, fb = marching_tetrahedra(np.sqrt(x**2 + (y / 0.8) ** 2 + (z / 0.6) ** 2) - 0.7, spacing=(2 / 23,) * 3)
    save_obj(str(src / "ball.obj"), vb, fb)
    v, f = make_sphere_mesh(24, 48, radius=0.5)
    keep = np.random.default_rng(0).random(len(f)) > 0.05
    save_obj(str(src / "open.obj"), v, f[keep])
    split = tmp_path / "split.json"
    split.write_text(json.dumps(["ball.obj", "open.obj", "missing.obj"]))
    return src, split


@pytest.mark.parametrize("mode", ["sdf", "test", "surface"])
def test_preprocess_data_cli_matches_root(mode, meshes, tmp_path):
    src, split = meshes
    flags = {"sdf": [], "test": ["--test"], "surface": ["--surface"]}[mode]
    common = ["-s", str(src), "--split", str(split), "--samples", "6000", *flags]
    _root("preprocess_data.py", "-d", str(tmp_path / "ref"), *common, cwd=tmp_path)
    r = _port("msd_tpu_torch.preprocess_data", "-d", str(tmp_path / "port"), *common, "--device", "cpu",
              cwd=tmp_path)
    ref, port = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert sorted(ref) == sorted(port)
    sub = "SurfaceSamples" if mode == "surface" else "SdfSamples"
    ext = ".ply" if mode == "surface" else ".npz"
    expected = {os.path.join(sub, "meshes", n + ext) for n in ("ball", "open")}
    assert expected <= set(port)
    for rel in ref:
        if rel.endswith(".npz"):
            a, b = np.load(tmp_path / "ref" / rel), np.load(tmp_path / "port" / rel)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (rel, k)
        elif rel.endswith(".ply"):
            pa, pb = load_ply(str(tmp_path / "ref" / rel))[0], load_ply(str(tmp_path / "port" / rel))[0]
            assert pa.tobytes() == pb.tobytes(), rel
            assert ref[rel] == port[rel]
        else:
            assert json.loads(ref[rel]) == json.loads(port[rel]), rel
    stats = [json.loads(ln.split("preprocess_stats ", 1)[1]) for ln in r.stderr.splitlines()
             if "preprocess_stats " in ln]
    assert [s["mesh"] for s in stats] == ["ball", "open"]
    assert {s["mode"] for s in stats} == {mode}
    if mode != "surface":
        assert [s["visibility"] for s in stats] == ["watertight", "render"]
        assert all(s["vote"]["route"] == "host" for s in stats)
    assert "No mesh found for instance missing.obj" in r.stderr


def test_run_all_preprocessing(meshes, tmp_path):
    """The port's run_all_preprocessing once (CLI defaults, --device cpu):
    SDF, test and surface passes over each split file (one empty)."""
    src, _ = meshes
    splits = tmp_path / "splits"
    splits.mkdir()
    (splits / "a_split.json").write_text(json.dumps([]))
    (splits / "b_split.json").write_text(json.dumps(["open.obj"]))
    data = tmp_path / "data"
    r = _port("msd_tpu_torch.run_all_preprocessing", "-d", str(data), "-s", str(src),
              "--splits_dir", str(splits), "--device", "cpu", "--debug", cwd=tmp_path)
    for name in ("open",):
        npz = np.load(data / "SdfSamples" / "meshes" / f"{name}.npz")
        assert npz["pos"].shape[1] == 4 and len(npz["pos"]) + len(npz["neg"]) > 400000
        assert (npz["pos"][:, 3] >= 0).all() and (npz["neg"][:, 3] < 0).all()
        assert load_ply(str(data / "SurfaceSamples" / "meshes" / f"{name}.ply"))[0].shape == (30000, 3)
        params = np.load(data / "NormalizationParameters" / "meshes" / f"{name}.npz")
        assert params["offset"].shape == (3,) and float(params["scale"]) > 0
    assert json.loads((data / ".datasources.json").read_text()) == {"meshes": str(src)}
    stats = [json.loads(ln.split("preprocess_stats ", 1)[1]) for ln in r.stderr.splitlines()
             if "preprocess_stats " in ln]
    # the --test pass finds the SdfSamples written and skips (--skip)
    assert [(s["mesh"], s["mode"]) for s in stats] == [("open", "sdf"), ("open", "surface")]
    assert stats[0]["visibility"] == "render" and stats[0]["vote"]["route"] == "host"
    assert stats[0]["queries"] == 500000


def _masks(d):
    d.mkdir()
    x, y, z = np.meshgrid(*[np.linspace(-1, 1, 28)] * 3, indexing="ij")
    for i, ax in enumerate([(0.8, 0.6, 0.5), (0.6, 0.7, 0.4)]):
        m = ((x / ax[0]) ** 2 + (y / ax[1]) ** 2 + (z / ax[2]) ** 2 < 1).astype(np.uint8)
        save_nifti(str(d / f"mask{i}.nii.gz"), m, zooms=(0.7, 0.8, 0.9))


def _cube_meshes(d):
    d.mkdir()
    verts = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    save_obj(str(d / "a.obj"), verts * 10.0, faces)
    save_obj(str(d / "b.obj"), verts * 25.0 + 5.0, faces)
    save_obj(str(d / "open.obj"), verts * 10.0, faces[:-1])


def _ply_meshes(d):
    d.mkdir()
    v, f = make_sphere_mesh(12, 24)
    for i in range(10):
        save_ply(str(d / f"m{i}.ply"), v * (1 + 0.1 * i), f)
    save_ply(str(d / "cloud.ply"), v)  # a point cloud: no faces


def _subject_meshes(d):
    d.mkdir()
    for sid in range(12):
        for visit in range(2):
            (d / f"ADNI_{sid:03d}_S_{100 + sid}_v{visit}.obj").write_text("")
    (d / "unmatched.obj").write_text("")
    with open(d.parent / "meta.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["subject_id", "diagnosis"])
        for sid in range(12):
            w.writerow([f"{sid:03d}_S_{100 + sid}", ("CN", "AD", "MCI")[sid % 3]])


def _labels_csv(d):
    d.mkdir()
    with open(d / "meta.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "diagnosis", "age"])
        for i in range(6):
            w.writerow([f"shape_{i}", i % 2, 60 + 3 * i if i != 4 else ""])


UTILS = {  # case: (script, inputs, arguments)
    "batch_process_to_ply": ("batch_process_to_ply", _masks, ["-i", "in", "-o", "out", "-g", "hippo"]),
    "mesh_scaling": ("mesh_scaling", _cube_meshes, ["-i", "in", "-o", "out"]),
    "create_split_json_files": ("create_split_json_files", _ply_meshes,
                                ["-m", "in", "-o", "out", "-p", "toy", "--ext", ".ply", "--seed", "3"]),
    "create_split_json_files_subjects": ("create_split_json_files", _subject_meshes, [
        "-m", "in", "-o", "out", "-p", "adni", "--subject_pattern", r"ADNI_(\d+_S_\d+)_",
        "--metadata_csv", "meta.csv", "--allowed_labels", "CN", "AD", "--stratify",
        "--fractions", "0.6", "0.2", "0.2", "--seed", "5"]),
    "ply_to_obj": ("ply_to_obj", _ply_meshes, ["-i", "in", "-o", "out"]),
    "label_creation_json": ("label_creation", _labels_csv, [
        "--csv", "in/meta.csv", "--columns", "diagnosis", "age", "--normalize", "age", "--out", "out/labels.json"]),
    "label_creation_pt": ("label_creation", _labels_csv, [
        "--csv", "in/meta.csv", "--columns", "age", "diagnosis", "--out", "out/labels.pt"]),
}


@pytest.mark.parametrize("case", list(UTILS))
def test_utils_cli_matches_root(case, tmp_path):
    """Each utils script and its port on the same inputs: the same files,
    byte for byte (labels.pt: the same map), and the same printout."""
    name, make, args = UTILS[case]
    outs = {}
    for side in ("ref", "port"):
        cwd = tmp_path / side
        cwd.mkdir()
        make(cwd / "in")
        (cwd / "out").mkdir(exist_ok=True)
        if side == "ref":
            r = _root(os.path.join("utils", name + ".py"), *args, cwd=cwd)
        else:
            r = _port("msd_tpu_torch.utils." + name, *args, cwd=cwd)
        outs[side] = (_tree(cwd / "out"), r.stdout)
    (ref, ref_out), (port, port_out) = outs["ref"], outs["port"]
    assert ref and sorted(ref) == sorted(port)
    for rel in ref:
        if rel.endswith(".pt"):
            a = load_labels(str(tmp_path / "ref" / "out" / rel))
            b = torch.load(str(tmp_path / "port" / "out" / rel))
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
        else:
            assert ref[rel] == port[rel], rel
    assert ref_out == port_out


def test_nifti_roundtrip_equal(tmp_path):
    import msd_tpu.data.nifti as jn

    rng = np.random.default_rng(0)
    for i, data in enumerate([rng.random((5, 6, 7)).astype(np.float32), (rng.random((4, 3, 2)) > 0.5).astype(np.uint8)]):
        pt, pj = str(tmp_path / f"t{i}.nii.gz"), str(tmp_path / f"j{i}.nii")
        save_nifti(pt, data, zooms=(0.5, 1.0, 2.0))
        jn.save_nifti(pj, data, zooms=(0.5, 1.0, 2.0))
        for path in (pt, pj):
            dt, zt = load_nifti(path)
            dj, zj = jn.load_nifti(path)
            assert dt.tobytes() == dj.tobytes() and zt == zj
            np.testing.assert_array_equal(dt, data.astype(np.float64))


def test_geometry_equal():
    import msd_tpu.utils.geometry as jg
    import msd_tpu_torch.utils.geometry as tg

    v, f = make_sphere_mesh(12, 24, center=(0.3, -0.2, 0.1))
    np.testing.assert_array_equal(tg.equi_dist_points_on_sphere(37, 2.0), jg.equi_dist_points_on_sphere(37, 2.0))
    np.testing.assert_array_equal(tg.rotate(np.eye(4), 0.1, 0.2, 0.3), jg.rotate(np.eye(4), 0.1, 0.2, 0.3))
    for fn in ("scale_to_unit_sphere", "scale_to_unit_cube"):
        (vt, _), ct, st = getattr(tg, fn)(v, f, return_stats=True)
        (vj, _), cj, sj = getattr(jg, fn)(v, f, return_stats=True)
        assert vt.tobytes() == vj.tobytes() and ct.tobytes() == cj.tobytes() and st == sj
    assert tg.is_watertight(f) == jg.is_watertight(f)
    assert tg.comp_fc_net_frac_params(1e6, 256, 2) == jg.comp_fc_net_frac_params(1e6, 256, 2)


@pytest.mark.parametrize("kind", ["plain", "subjects", "stratified"])
def test_split_writers_equal(kind, tmp_path):
    names = [f"ADNI_{s:03d}_S_{s + 7}_scan{v}.obj" for s in range(20) for v in range(s % 3 + 1)]
    if kind == "plain":
        pt = tsplits.create_split_files(names, str(tmp_path / "t"), "p", seed=11)
        pj = jsplits.create_split_files(names, str(tmp_path / "j"), "p", seed=11)
    else:
        meta = tmp_path / "meta.csv"
        with open(meta, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["subject_id", "diagnosis"])
            for s in range(18):
                w.writerow([f"{s:03d}_S_{s + 7}", ("CN", "AD", "MCI")[s % 3]])
        kw = dict(seed=42)
        if kind == "stratified":
            kw.update(metadata_csv=str(meta), allowed_labels=["CN", "AD"], stratify=True)
        pt = tsplits.create_subject_split_files(names, str(tmp_path / "t"), "p", **kw)
        pj = jsplits.create_subject_split_files(names, str(tmp_path / "j"), "p", **kw)
        assert pt.pop("summary") == pj.pop("summary")
    assert sorted(pt) == sorted(pj)
    for k in pt:
        with open(pt[k], "rb") as a, open(pj[k], "rb") as b:
            assert a.read() == b.read(), k
