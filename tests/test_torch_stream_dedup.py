"""The corner dedup of msd_tpu_torch's streaming create_mesh against
msd_tpu's on the CPU: the knob's decision in every host cell, the owner-row
map, the per-shift orphan caps and the orphan overflow flag exactly; each
shift's orphan rows against a numpy recomputation from the map; the dedup
slab's float16 rows and the deduplicated mesh bit for bit what the plain
slabs give (per value codec), with fewer points evaluated; the orphan
overflow retry; and the default gate (msd_tpu/mesh.py:1040-1060).

On test_torch_streaming_mesh.py's fitted 64-wide pair at N=129, one torch
thread, ``A_CHUNK`` 2048 in both packages."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msd_tpu import mesh as jax_mesh
from msd_tpu import stream_knobs as jax_knobs
from msd_tpu_torch import mesh
from msd_tpu_torch import stream_knobs
from test_torch_streaming_mesh import CODECS, H, N, one_thread, pair, port_stream, streams  # noqa: F401

M = mesh.PointEvaluator.MAP_N
KNOB_CELLS = list(itertools.product((1, 2, 8), (False, True), (16383, 16384)))
ACCELERATOR = stream_knobs.HostFacts(cores=8, cpu_backend=False, native_decode=True, simd_decode=True)


@pytest.fixture
def env(streams, monkeypatch):
    """Both packages slab by 2048 blocks; no streaming knob set."""
    monkeypatch.setattr(jax_mesh.PointEvaluator, "A_CHUNK", 2048)
    monkeypatch.setattr(mesh.PointEvaluator, "A_CHUNK", 2048)
    for var in ("MSD_STREAM_SLABS", "MSD_VALUE_CODEC", "MSD_STREAM_DEDUP", "MSD_STREAM_HYBRID",
                "MSD_ORPHAN_SHIFT_CAP_MILLI", "MSD_STREAM_OPT"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def active(pair):
    """The port's device refinement at N=129: (evaluator, abi_dev [cap, 3]
    int32, active count A, host rows [A, 3])."""
    _, _, tdec, latent = pair
    ev = mesh.PointEvaluator(tdec)
    resolver, A, _, abi_dev = ev.refine_active4_device(torch.tensor(latent), N, 1.3, 0.1, async_fetch=True)
    return ev, abi_dev, A, resolver()


def slabs(A, C=2048):
    """(start, valid rows) of every A_CHUNK-aligned slab of the active set."""
    return [(lo, min(C, A - lo)) for lo in range(0, A, C)]


@pytest.mark.parametrize("cores,cpu,blocks", KNOB_CELLS)
def test_dedup_streaming_matches_jax(cores, cpu, blocks, monkeypatch):
    """Every host cell under every MSD_STREAM_DEDUP gives msd_tpu's answer."""
    kw = dict(cores=cores, cpu_backend=cpu, native_decode=True, simd_decode=True)
    for value in (None, "auto", "on", "off"):
        if value is None:
            monkeypatch.delenv("MSD_STREAM_DEDUP", raising=False)
        else:
            monkeypatch.setenv("MSD_STREAM_DEDUP", value)
        ours = stream_knobs.dedup_streaming(stream_knobs.HostFacts(**kw), blocks)
        assert ours is jax_knobs.dedup_streaming(jax_knobs.HostFacts(**kw), blocks), value
        assert stream_knobs.dedup_forced() is (value == "on")


def test_owner_map_and_shift_caps_match_jax(pair, active):
    """The owner-row map equals msd_tpu's entry for entry, on the active
    set and with the rows past a smaller count dropped; the per-shift caps
    equal msd_tpu's."""
    ev, abi_dev, A, abi = active
    jev = jax_mesh.PointEvaluator(pair[0], pair[1])
    jabi = jnp.asarray(abi_dev.numpy())
    for count in (A, A // 2):
        ref = np.asarray(jev._get_block_map_fn(abi_dev.shape[0])(jabi, jnp.int32(count)))
        ours = ev._block_map(abi_dev, count).numpy()
        assert ours.shape == (M**3 + 1,) and ours[-1] == -1
        np.testing.assert_array_equal(ours[:-1], ref.reshape(-1))
    assert (ours[:-1] >= 0).sum() == A // 2
    for n_pad in (2048, 4096, 8192, 24576, 57344):
        for rho_m in (0, 1, 100, 250, 500, 1000):
            assert mesh.PointEvaluator._dedup_shift_caps(n_pad, rho_m / 1000) == \
                jax_mesh.PointEvaluator._dedup_shift_caps(n_pad, rho_m / 1000), (n_pad, rho_m)


def test_orphan_rows_match_the_map(active):
    """Per slab and shift: the owner's row within the slab, the orphan rows
    (valid rows whose owner is absent or outside the slab, in row order, the
    first capS) and their count, against numpy on the map."""
    ev, abi_dev, A, abi = active
    full = ev._block_map(abi_dev, A).numpy()[:-1].reshape(M, M, M)
    shifts = mesh._dedup_tables()["shifts"]
    for (lo, n), capS in itertools.product(slabs(A), (0, 1024)):
        abi_slab = abi_dev[lo:lo + 2048]
        locals_, orphans, counts = ev._dedup_plan(abi_slab, ev._block_map(abi_dev, A), lo, n, capS)
        rows = np.arange(abi_slab.shape[0])
        for si, sh in enumerate(shifts):
            owner = abi_slab.numpy() + sh
            inb = ((owner >= 0) & (owner < M)).all(1)
            orow = np.full(owner.shape[0], -1)
            orow[inb] = full[tuple(owner[inb].T)]
            in_slab = (orow >= lo) & (orow < lo + n)
            absent = np.nonzero(~in_slab & (rows < n))[0]
            np.testing.assert_array_equal(locals_[si].numpy(), np.where(in_slab, orow - lo, abi_slab.shape[0]))
            assert int(counts[si]) == absent.size
            k = min(absent.size, capS)
            np.testing.assert_array_equal(orphans[si].numpy()[:k], absent[:k])
            assert orphans[si].shape == (capS,)


@pytest.mark.parametrize("C", [2048, 8192])
def test_overflow_flag_matches_jax(pair, active, C, monkeypatch):
    """Header slot 3 of each dedup slab (the orphan overflow flag) equals
    msd_tpu's dedup program's, at caps that hold every orphan, that hold
    none, and between; slots 0-2 too."""
    jdec, params, _, latent = pair
    ev, abi_dev, A, _ = active
    monkeypatch.setattr(mesh.PointEvaluator, "A_CHUNK", C)
    jev = jax_mesh.PointEvaluator(jdec, params)
    q = mesh.PointEvaluator._codec_q("f16", H)
    map_dev = ev._block_map(abi_dev, A)
    jabi = jnp.asarray(abi_dev.numpy())
    jmap = jev._get_block_map_fn(abi_dev.shape[0])(jabi, jnp.int32(A))
    flags = []
    for (lo, n), rho_m in itertools.product(slabs(A, C), (0, 20, 250)):
        n_pad = -(-n // C) * C
        ours = ev._slab_dedup(torch.tensor(latent), abi_dev, map_dev, lo, n, H, q, n_pad, "f16", rho_m)[0].numpy()
        ref = np.asarray(jev._get_slab_compact_dedup_fn(n_pad, n_pad, "f16", rho_m)(
            jnp.asarray(latent), jabi, jmap, jnp.int32(lo), jnp.int32(n), jnp.float32(H), jnp.int32(1),
            jnp.float32(q))[0])
        assert ours.dtype == ref.dtype == np.uint16
        np.testing.assert_array_equal(ours[:4], ref[:4])
        flags.append(int(ours[3]))
    assert 0 in flags and 1 in flags


@pytest.mark.parametrize("C", [2048, 8192])
def test_dedup_rows_equal_plain_rows(pair, active, C, monkeypatch):
    """Each slab's deduplicated [n, 125] float16 rows equal the plain
    slab's bit for bit (valid rows; the rows past them are the refinement's
    padding or the next slab's), with no orphan overflow."""
    _, _, _, latent = pair
    ev, abi_dev, A, _ = active
    monkeypatch.setattr(mesh.PointEvaluator, "A_CHUNK", C)
    map_dev = ev._block_map(abi_dev, A)
    for lo, n in slabs(A, C):
        vals, flag = ev._dedup_values(torch.tensor(latent), abi_dev, map_dev, lo, n, H, 250)
        plain = ev._blocks_f16(torch.tensor(latent), abi_dev[lo:lo + vals.shape[0]], H)
        assert int(flag) == 0 and vals.dtype == torch.float16
        assert torch.equal(vals[:n], plain[:n])


def stream(pair, codec, dedup, monkeypatch, **env):
    monkeypatch.setenv("MSD_STREAM_DEDUP", dedup)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return port_stream(mesh.PointEvaluator(pair[2]), pair[3], codec)


@pytest.mark.parametrize("codec", CODECS)
def test_dedup_mesh_equals_plain_mesh(pair, env, codec):
    """MSD_STREAM_DEDUP=on: the streamed mesh equals the plain streamed
    mesh bit for bit, with fewer than 0.8 x its points evaluated
    (msd_tpu's tests/test_streaming_mesh.py:321-349) and no retry."""
    (pv, pf), plain = stream(pair, codec, "off", env)
    (dv, df), dedup = stream(pair, codec, "on", env)
    np.testing.assert_array_equal(dv, pv)
    np.testing.assert_array_equal(df, pf)
    assert not plain["dedup"] and plain["dedup_slabs"] == 0
    assert dedup["dedup"] and dedup["dedup_slabs"] >= 2
    assert dedup["dedup_retries"] == 0 and dedup["exact_slabs"] == 0
    assert dedup["evaluated"] < 0.8 * plain["evaluated"], (dedup["evaluated"], plain["evaluated"])


def test_orphan_overflow_retries_every_slab(pair, env):
    """MSD_ORPHAN_SHIFT_CAP_MILLI=0 leaves no orphan slot: every dedup
    slab's header is flagged, each slab runs once more as a plain slab,
    and the mesh is the plain one (msd_tpu's :352-377)."""
    (pv, pf), _ = stream(pair, "packed", "off", env)
    (dv, df), stats = stream(pair, "packed", "on", env, MSD_ORPHAN_SHIFT_CAP_MILLI="0")
    np.testing.assert_array_equal(dv, pv)
    np.testing.assert_array_equal(df, pf)
    assert stats["dedup"] and stats["dedup_slabs"] >= 2
    assert stats["dedup_retries"] == stats["dedup_slabs"] and stats["exact_slabs"] == 0


def test_gate_cells(active, env):
    """``_dedup_on``: under auto on an accelerator host, the two-level class
    from 16384 blocks, never the single-level class; "on" either class;
    never without a device active set or past the owner map."""
    ev, abi_dev, _, _ = active
    env.setattr(stream_knobs, "host_facts", lambda: ACCELERATOR)
    assert ev._dedup_on(abi_dev, 513, 16384, True)
    assert not ev._dedup_on(abi_dev, 513, 16383, True)
    assert not ev._dedup_on(abi_dev, 257, 19989, False)
    assert not ev._dedup_on(None, 513, 45394, True)
    assert not ev._dedup_on(abi_dev, 517, 45394, True)
    env.setenv("MSD_STREAM_DEDUP", "on")
    assert ev._dedup_on(abi_dev, 257, 19989, False) and ev._dedup_on(abi_dev, 129, 10, False)
    assert not ev._dedup_on(None, 129, 10, False)
    env.setenv("MSD_STREAM_DEDUP", "off")
    assert not ev._dedup_on(abi_dev, 513, 45394, True)


class _Gate(Exception):
    pass


@pytest.mark.parametrize("n,facts,expected", [
    (N, ACCELERATOR, False),       # single level (and under 16384 blocks)
    (385, ACCELERATOR, True),      # two levels, 25668 blocks
    (385, None, False),            # the CPU host itself
], ids=["single_level", "two_level", "two_level_on_cpu"])
def test_default_gate(pair, env, n, facts, expected):
    """Under the default environment create_mesh dedups where a default
    msd_tpu on an accelerator host does: the two-level class from 16384
    blocks, not the single-level class. (The stream stops at the gate.)"""
    if facts is not None:
        env.setattr(stream_knobs, "host_facts", lambda: facts)
    seen = []
    gate = mesh.PointEvaluator._dedup_on

    def record(self, abi_dev, n_, A, two_level):
        seen.append((A, two_level, gate(self, abi_dev, n_, A, two_level)))
        raise _Gate

    env.setattr(mesh.PointEvaluator, "_dedup_on", record)
    with pytest.raises(_Gate):
        port_stream(mesh.PointEvaluator(pair[2]), pair[3], "packed", n)
    (A, two_level, on), = seen
    assert two_level == (n == 385) and on is expected
    assert (A >= 16384) == (n == 385)
