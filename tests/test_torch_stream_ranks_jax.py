"""The port's streamed ``create_mesh`` over 3 gloo ranks against msd_tpu's
``create_mesh`` through ``PointEvaluator(mesh=)`` on its 8 virtual CPU
devices, per value codec at N=129: the same weights (the port decoder of
tests/test_torch_stream_ranks.py, fitted to an ellipsoid, given to msd_tpu
through ``params_from_torch_state_dict``), the rank function of that module
(which imports no JAX), and the bounds tests/test_torch_streaming_mesh.py
holds between the two packages' one-device streams: equal active and
crossing blocks, points, vertices and faces, and every vertex more than
1e-4 from msd_tpu's explained by a lattice value one codec step apart.
Both packages slab by 2048 blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from msd_tpu import mesh as jax_mesh
from msd_tpu.models.deepsdf import DeepSDFDecoder as JaxDecoder
from msd_tpu_torch.parallel import run_ranks
from test_torch_dp import TIMEOUT, cpus
from test_torch_stream_ranks import LATENT, NET, RANKS, fitted_decoder, one_thread, stream_rank  # noqa: F401
from test_torch_streaming_mesh import CODECS, N, assert_differences_are_codec_steps, small_chunk, streams  # noqa: F401

CASES = [dict(name=codec, N=N, codec=codec) for codec in CODECS]


@pytest.fixture(scope="module")
def both(one_thread, tmp_path_factory):  # noqa: F811
    """The port decoder and latent, msd_tpu's decoder and params with the
    same weights, and one spawn of 3 port ranks streaming every codec."""
    tdec, latent = fitted_decoder()
    out_dir = str(tmp_path_factory.mktemp("stream_ranks_jax"))
    ranks = run_ranks(stream_rank, RANKS, ({"fitted": tdec}, latent, CASES, out_dir), devices=cpus(RANKS),
                      timeout=TIMEOUT)
    jdec = JaxDecoder(LATENT, dims=NET["dims"], latent_in=NET["latent_in"], weight_norm=True, norm_layers=[])
    # copies: the spawn moved the port decoder's storage to shared memory
    params = jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)),
                          jdec.params_from_torch_state_dict(tdec.state_dict()))
    return tdec, latent, jdec, params, ranks


@pytest.mark.parametrize("codec", CODECS)
def test_streamed_mesh_ranks_against_jax_mesh(both, small_chunk, codec):  # noqa: F811
    tdec, latent, jdec, params, ranks = both
    assert len(jax.devices()) == 8
    ev = jax_mesh.PointEvaluator(jdec, params, mesh=Mesh(np.array(jax.devices()), ("data",)))
    rv, rf = jax_mesh.create_mesh(jdec, params, latent, N=N, return_mesh=True, evaluator=ev, value_codec=codec)
    rstats = dict(jax_mesh.LAST_STREAMING_STATS)
    stats = ranks[0][codec]["stats"]
    assert stats["refine"] == "device" and stats["exact_slabs"] == 0
    for key in ("active_blocks", "crossing_blocks", "evaluated", "num_verts", "num_faces"):
        assert stats[key] == rstats[key], key
    for r, out in enumerate(ranks):
        assert out[codec]["error"] is None, out[codec]["error"]
        v, f = out[codec]["result"]
        assert v.shape == rv.shape and f.shape == rf.shape, r
        np.testing.assert_array_equal(v, ranks[0][codec]["result"][0])
    assert_differences_are_codec_steps(jdec, params, tdec, latent, codec, ranks[0][codec]["result"][0], rv)
