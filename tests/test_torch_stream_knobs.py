"""msd_tpu_torch.stream_knobs against msd_tpu.stream_knobs: every cell of
tests/test_stream_knobs.py's codec matrix, with the same environment,
gives msd_tpu's answer; the slab count reads MSD_STREAM_SLABS as
msd_tpu's stream does."""

import itertools

import pytest
import torch

from msd_tpu import stream_knobs as jax_knobs
from msd_tpu_torch import mesh
from msd_tpu_torch import stream_knobs
from msd_tpu_torch.native import load_native


def both_facts(cores=1, native=False, simd=False, cpu=True):
    kw = dict(cores=cores, cpu_backend=cpu, native_decode=native, simd_decode=simd)
    return stream_knobs.HostFacts(**kw), jax_knobs.HostFacts(**kw)


CODEC_CELLS = list(itertools.product((1, 2, 8), (False, True), (False, True)))


def set_env(monkeypatch, names, value):
    for name in names:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)


@pytest.mark.parametrize("cores,native,simd", CODEC_CELLS)
def test_value_codec_matches_jax(cores, native, simd, monkeypatch):
    """Each host cell, every request under every MSD_VALUE_CODEC."""
    ours, theirs = both_facts(cores=cores, native=native, simd=simd)
    for env in (None, "auto", "f16", "int8", "packed"):
        set_env(monkeypatch, ["MSD_VALUE_CODEC"], env)
        for requested in ("auto", "packed", "int8", "f16"):
            assert stream_knobs.resolve_value_codec(requested, ours) == \
                jax_knobs.resolve_value_codec(requested, theirs), (env, requested)


@pytest.mark.parametrize("value,slabs", [(None, 3), ("1", 1), ("3", 3), ("8", 8)])
def test_stream_slab_count(value, slabs, monkeypatch):
    """MSD_STREAM_SLABS, default 3, as msd_tpu/mesh.py:963 reads it."""
    set_env(monkeypatch, ["MSD_STREAM_SLABS"], value)
    assert stream_knobs.stream_slab_count() == slabs


def test_host_facts_real(monkeypatch):
    """host_facts() reads the port's own library; mesh._resolve_value_codec
    delegates to the table."""
    lib = load_native()
    f = stream_knobs.host_facts()
    assert f.cores >= 1 and f.native_decode and f.cpu_backend == (not torch.cuda.is_available())
    assert f.simd_decode == bool(lib.msd_codec_simd())
    monkeypatch.delenv("MSD_VALUE_CODEC", raising=False)
    monkeypatch.setattr(stream_knobs, "host_facts", lambda: both_facts(cores=1)[0])
    assert mesh._resolve_value_codec("auto") == "int8"
    assert mesh._resolve_value_codec("f16") == "f16"
