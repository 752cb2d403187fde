"""The segment reductions of the port (``uemda_tpu_torch/ops/segment.py``) on
the CPU against the JAX package: the plain versions of K5 (segment max), K6
(segment sum) and K7 (gather-back) against both JAX routes -- the default
``jax.ops`` segment reductions and ``take_along_axis``, and the Pallas
kernels in interpret mode (as ``tests/test_ops_segment.py:64-108`` runs
them) -- then ``superpixel_view_probs`` and ``superpixel_expand``, and the
contract at the edges (empty segments, ids out of range)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uemda_tpu.ops import segment as jseg
from uemda_tpu.ops.pallas_kernels import (
    segment_gather_pallas,
    segment_max_pallas,
    segment_sum_pallas,
)
from uemda_tpu_torch.datasets.synthetic import grid_superpixels
from uemda_tpu_torch.ops.segment import (
    segment_gather,
    segment_max,
    segment_sum,
    superpixel_expand,
    superpixel_view_probs,
)


def _case(seed, b=2, hw=48, c=7, cell=8, extra=5):
    """Softmax-like values and grid superpixel ids (boundary ring = the max
    id) with ``extra`` empty segments above the top id."""
    r = np.random.default_rng(seed)
    sup = np.stack([np.roll(grid_superpixels(hw, cell), (r.integers(cell),) * 2,
                            axis=(0, 1)) for _ in range(b)])
    s = int(sup.max()) + 1 + extra
    val = r.random((b, hw * hw, c)).astype(np.float32)
    return val, sup.reshape(b, -1).astype(np.int32), s


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64])
def test_plain_segment_max_sum_gather_match_jax_default_route(ids_dtype):
    """Max and gather exact (every segment, -inf where empty); the sum of
    random values to 1e-6 relative (another summation order), of one-hot
    values exactly (integer counts in f32)."""
    val, ids, s = _case(0)
    ids = ids.astype(ids_dtype)
    tv, ti = torch.from_numpy(val), torch.from_numpy(ids)
    want = np.asarray(jseg.segment_max(jnp.asarray(val), jnp.asarray(ids), s))
    got = segment_max(tv, ti, s).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[:, -5:]).all()
    want = np.asarray(jseg.segment_sum(jnp.asarray(val), jnp.asarray(ids), s))
    np.testing.assert_allclose(segment_sum(tv, ti, s).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    oh = np.eye(7, dtype=np.float32)[np.random.default_rng(1).integers(
        0, 7, ids.shape)]
    want = np.asarray(jseg.segment_sum(jnp.asarray(oh), jnp.asarray(ids), s))
    np.testing.assert_array_equal(
        segment_sum(torch.from_numpy(oh), ti, s).numpy(), want)
    table = segment_max(tv, ti, s)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(table.numpy()),
                                          jnp.asarray(ids)[..., None], axis=1))
    np.testing.assert_array_equal(segment_gather(table, ti).numpy(), want)


def test_plain_segments_match_the_pallas_kernels_in_interpret_mode():
    """The Pallas kernels on the occupied segments: max exact, one-hot sums
    exact (HIGHEST-precision one-hot products), and the gather exact."""
    val, ids, s = _case(2, b=2, hw=32, cell=8, extra=3)
    jv, ji = jnp.asarray(val), jnp.asarray(ids)
    tv, ti = torch.from_numpy(val), torch.from_numpy(ids)
    got = segment_max(tv, ti, s).numpy()
    want = np.asarray(segment_max_pallas(jv, ji, s, tile=256))
    occ = np.isfinite(got)
    assert (~occ).sum() == 2 * 3 * 7            # the three empty segments
    np.testing.assert_array_equal(got[occ], want[occ])
    oh = np.eye(7, dtype=np.float32)[np.random.default_rng(3).integers(
        0, 7, ids.shape)]
    np.testing.assert_array_equal(
        segment_sum(torch.from_numpy(oh), ti, s).numpy(),
        np.asarray(segment_sum_pallas(jnp.asarray(oh), ji, s, tile=256)))
    table = np.where(occ, got, 0.0).astype(np.float32)
    np.testing.assert_array_equal(
        segment_gather(torch.from_numpy(table), ti).numpy(),
        np.asarray(segment_gather_pallas(jnp.asarray(table), ji, tile=256)))


def test_edges_empty_segments_and_out_of_range_ids():
    """The JAX default route's contract, which the port keeps: an empty
    segment is -inf (max) and 0 (sum); an id >= S is left out of both
    reductions and gathers back NaN (``take_along_axis`` fill mode). A
    negative id is left out and gathers NaN too (JAX would wrap it; maps
    are unsigned). The Pallas kernels differ here (-3e38 and 0), which is
    why the port follows the default route."""
    val = np.arange(2 * 6 * 2, dtype=np.float32).reshape(2, 6, 2) - 5.0
    ids = np.array([[0, 0, 2, 9, 4, 2], [1, 1, 1, 3, 7, 0]], np.int32)
    s = 4
    tv, ti = torch.from_numpy(val), torch.from_numpy(ids)
    mx = segment_max(tv, ti, s).numpy()
    sm = segment_sum(tv, ti, s).numpy()
    np.testing.assert_array_equal(
        mx, np.asarray(jseg.segment_max(jnp.asarray(val), jnp.asarray(ids), s)))
    np.testing.assert_array_equal(
        sm, np.asarray(jseg.segment_sum(jnp.asarray(val), jnp.asarray(ids), s)))
    assert np.isneginf(mx[0, 1]).all() and np.isneginf(mx[0, 3]).all()
    assert (sm[0, 1] == 0).all() and (sm[1, 2] == 0).all()
    g = segment_gather(torch.from_numpy(np.nan_to_num(mx, neginf=-1.0)),
                       ti).numpy()
    want = np.asarray(jnp.take_along_axis(
        jnp.asarray(np.nan_to_num(mx, neginf=-1.0)), jnp.asarray(ids)[..., None],
        axis=1))
    np.testing.assert_array_equal(g, want)
    assert np.isnan(g[0, 3:5]).all() and np.isnan(g[1, 4]).all()
    assert not np.isnan(np.delete(g[0], [3, 4], axis=0)).any()
    neg = torch.tensor([[-1, 0, 1, 2, 3, 0]], dtype=torch.int32)
    assert torch.isnan(segment_gather(torch.zeros(1, 4, 2), neg)[0, 0]).all()
    assert segment_sum(torch.ones(1, 6, 2), neg, 4).sum() == 10.0


def test_superpixel_view_probs_matches_jax():
    """(B, C, H, W) probabilities pooled by max over their superpixel, the
    port's layout against the JAX package's NHWC, both routes; exact."""
    r = np.random.default_rng(4)
    probs = r.random((2, 40, 40, 6)).astype(np.float32)
    sup = np.stack([grid_superpixels(40, 8), np.roll(grid_superpixels(40, 8), 3)])
    s = int(sup.max()) + 9
    got = superpixel_view_probs(
        torch.from_numpy(probs).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), torch.from_numpy(sup), s)
    assert got.shape == (2, 6, 40, 40)
    got = got.permute(0, 2, 3, 1).numpy()
    for impl in ("xla", "pallas"):
        want = np.asarray(jseg.superpixel_view_probs(
            jnp.asarray(probs), jnp.asarray(sup), s, impl=impl))
        np.testing.assert_array_equal(got, want)


def test_superpixel_expand_matches_jax():
    """The majority vote (K6 counts, ties to the lower class, ignore for a
    superpixel with no labelled pixel), exact; an id >= S reads the int32
    minimum, as JAX's fill."""
    r = np.random.default_rng(5)
    label = r.integers(-1, 6, (2, 32, 32)).astype(np.int32)
    label[0, :8, :8] = -1                        # one unlabelled superpixel
    label[1, :8, :8] = np.kron([[2, 3], [3, 2]], np.ones((4, 4), np.int32))
    sup = np.stack([grid_superpixels(32, 8)] * 2)
    sup[1, 20, 20] = 99
    s = int(sup[sup < 99].max()) + 1
    got = superpixel_expand(torch.from_numpy(label), torch.from_numpy(sup), 6,
                            s).numpy()
    want = np.asarray(jseg.superpixel_expand(jnp.asarray(label),
                                             jnp.asarray(sup), 6, s))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 1:7, 1:7] == -1).all() and (got[1, 1:7, 1:7] == 2).all()
    assert got[1, 20, 20] == np.iinfo(np.int32).min


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """A CPU tensor never counts as a kernel launch."""
    fns = (segment_max, segment_sum, segment_gather)
    before = [f.launches for f in fns]
    val, ids, s = _case(6, b=1, hw=16, cell=8, extra=0)
    tv, ti = torch.from_numpy(val), torch.from_numpy(ids)
    segment_gather(segment_max(tv, ti, s), ti)
    segment_sum(tv, ti, s)
    assert [f.launches for f in fns] == before
    assert jax.devices()[0].platform == "cpu"
