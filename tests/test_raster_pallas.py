"""The Hopper raster kernel (ops.raster_pallas) in the Pallas interpreter
on the CPU, its record layout and wrapper, and the rasterizer choice per
backend. The compiled kernel is compared on the card by the ``gpu`` test
at the end and by chip_smoke.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from crychic_renderer_tpu.ops import rasterizer as rz
from crychic_renderer_tpu.ops import raster_pallas as rp


def _random_scene(T=80, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, size=(T, 1, 4)).astype(np.float32)
    verts = (centers + rng.uniform(-0.25, 0.25, size=(T, 3, 4))).astype(
        np.float32).reshape(T * 3, 4)
    verts[:, 2] = rng.uniform(0.01, 0.99, T * 3)
    verts[:, 3] = 1.0
    idx = np.arange(T * 3, dtype=np.int32)
    return jnp.asarray(verts), jnp.asarray(idx)


def _screen_tris(xy, z):
    """ScreenTris from explicit screen-space vertices (T, 3, 2), z (T, 3)."""
    xy = jnp.asarray(xy, jnp.float32)
    return rz.ScreenTris(xy=xy, z=jnp.asarray(z, jnp.float32),
                         inv_w=jnp.ones(xy.shape[:2], jnp.float32),
                         valid=jnp.ones(xy.shape[0], bool))


def test_pallas_matches_brute_interpret():
    """The kernel (interpret mode on CPU) matches brute force on the same
    snapped coordinates."""
    W, H = 256, 64
    vb, ib = _random_scene(T=60)
    tris = rz.setup_triangles(vb, ib, W, H)
    tris_snapped = tris._replace(xy=rp.snap_xy(tris.xy))

    d_ref, t_ref = rz.rasterize_bruteforce(tris_snapped, W, H)
    d_pl, t_pl = rp.rasterize_pallas(tris, W, H, pair_capacity=4096,
                                     interpret=True)
    d_ref, t_ref = np.asarray(d_ref), np.asarray(t_ref)
    d_pl, t_pl = np.asarray(d_pl), np.asarray(t_pl)

    np.testing.assert_allclose(d_pl, d_ref, atol=2e-4)
    mismatch = (t_pl != t_ref)
    # ids may differ only where depths tie within fp noise or exactly on
    # edges (the top-left bias vs exact == differ in fp32 for big tris)
    assert mismatch.mean() < 0.02, f"{mismatch.sum()} mismatches"


def test_pallas_empty_and_full_tiles():
    """Tiles with zero triangles must come out cleared."""
    W, H = 256, 32
    verts = jnp.asarray(np.array(
        [[-1, 1, 0.5, 1], [0, 1, 0.5, 1], [-1, -1, 0.5, 1]], np.float32))
    idx = jnp.asarray(np.array([0, 1, 2], np.int32))
    tris = rz.setup_triangles(verts, idx, W, H)
    d, t = rp.rasterize_pallas(tris, W, H, pair_capacity=256, interpret=True)
    d, t = np.asarray(d), np.asarray(t)
    # right half of screen: no geometry
    assert (t[:, 192:] == -1).all()
    assert (d[:, 192:] == 1.0).all()
    # left quarter: covered
    assert (t[:, :32] == 0).mean() > 0.5


def test_record_layout():
    """build_records: one row-major (16,) record per sorted pair, planes
    re-anchored at the pair's tile origin, tri_block zero rows at the end
    so every block window of a run stays inside the array."""
    W, H = 2 * rp.TILE_W, 2 * rp.TILE_H
    # one triangle spanning all four tiles, CW in y-down screen space
    xy = [[[2.0, 1.0], [60.0, 3.0], [5.0, 15.0]]]
    tris = _screen_tris(xy, [[0.2, 0.4, 0.6]])
    ntx = 2
    bins = rz.bin_triangles(tris, W, H, 64, tile_h=rp.TILE_H,
                            tile_w=rp.TILE_W)
    rec = np.asarray(rp.build_records(tris, bins, ntx, 4,
                                      xrange=(jnp.asarray([1.0]),
                                              jnp.asarray([40.0]))))
    assert rec.shape == (64 + rp.TRI_BLOCK, rp.REC_COLS)
    assert (rec[-rp.TRI_BLOCK:] == 0).all()
    n = int(bins.num_valid)
    assert n == 4 and list(np.asarray(bins.sorted_tile)[:n]) == [0, 1, 2, 3]
    A, B, C, area2, tl = (np.asarray(v) for v in rz._edge_coeffs(
        jnp.asarray(xy, jnp.float32)))
    zA = (A * np.array([0.2, 0.4, 0.6]) / area2[:, None]).sum(-1)
    for k in range(n):
        x0 = (k % ntx) * rp.TILE_W
        y0 = (k // ntx) * rp.TILE_H
        r = rec[k]
        np.testing.assert_array_equal(r[0:3], A[0])
        np.testing.assert_array_equal(r[3:6], B[0])
        c_loc = C[0] + A[0] * x0 + B[0] * y0 - np.where(tl[0], 0,
                                                          rp.EDGE_EPS)
        np.testing.assert_allclose(r[6:9], c_loc, atol=1e-5)
        np.testing.assert_allclose(r[9], zA[0], rtol=1e-6)
        # depth at the tile origin, from the plane through the vertices
        z_at = r[11] + r[9] * (2.0 - x0) + r[10] * (1.0 - y0)
        np.testing.assert_allclose(z_at, 0.2, atol=1e-6)
        assert r[12] == 0.0  # triangle id
        np.testing.assert_array_equal(r[13:15], [1.0 - x0, 40.0 - x0])
        assert r[15] == 0.0


def test_xrange_column_guard():
    """A triangle crossing its atlas column's edge covers only pixel
    centers with xlo <= x < xhi."""
    W, H = 128, 16
    xy = [[[10.0, 0.0], [120.0, 0.0], [10.0, 16.0]]]
    tris = _screen_tris(xy, [[0.5, 0.5, 0.5]])
    free, _ = rp.rasterize_pallas(tris, W, H, 256, interpret=True)
    guard, _ = rp.rasterize_pallas(
        tris, W, H, 256, interpret=True,
        xrange=(jnp.asarray([32.0]), jnp.asarray([64.0])))
    free, guard = np.asarray(free), np.asarray(guard)
    cols = np.arange(W) + 0.5
    inside = (cols >= 32) & (cols < 64)
    assert (free[:, ~inside] < 1).any()
    assert (guard[:, ~inside] == 1.0).all()
    np.testing.assert_array_equal(guard[:, inside], free[:, inside])


def test_depth_only_matches_with_ids():
    """with_ids=False returns the same depth and no id buffer."""
    W, H = 128, 64
    vb, ib = _random_scene(T=50, seed=3)
    tris = rz.setup_triangles(vb, ib, W, H)
    d_ids, t_ids = rp.rasterize_pallas(tris, W, H, 4096, interpret=True)
    d, t = rp.rasterize_pallas(tris, W, H, 4096, interpret=True,
                               with_ids=False)
    assert t is None and t_ids is not None
    np.testing.assert_array_equal(np.asarray(d), np.asarray(d_ids))


@pytest.mark.parametrize("copies", [3, rp.TRI_BLOCK + 5])
def test_exact_z_tie_takes_min_id(copies):
    """Coplanar copies of one triangle tie exactly in z: the minimum id
    wins, within a block and across block boundaries (copies beyond
    TRI_BLOCK), also under interleaved binning."""
    W, H = 64, 16
    base = np.array([[2.0, 1.0], [60.0, 2.0], [4.0, 15.0]])
    # an unrelated triangle first so the tied ids do not start at 0
    xy = np.concatenate([[[[100.0, 0.0], [110.0, 0.0], [100.0, 8.0]]],
                         np.repeat(base[None], copies, 0)])
    z = np.full((copies + 1, 3), 0.3)
    tris = _screen_tris(xy, z)
    d, t = rp.rasterize_pallas(tris, W, H, 1024, interpret=True)
    t = np.asarray(t)
    covered = np.asarray(d) < 1
    assert covered.mean() > 0.3
    assert (t[covered] == 1).all()
    dd, tt = rp.rasterize_pallas(tris, W, H, 1024, interpret=True,
                                 row_stride=(2, 1))
    rows = slice(rp.TILE_H, 2 * rp.TILE_H)  # true tile row 1
    np.testing.assert_array_equal(np.asarray(tt)[:rp.TILE_H], t[rows])


def test_rasterizer_choice_per_backend():
    """The kernel on the GPU, the XLA reference on the CPU, an error on
    any other backend; the kernel runs on the CPU only in interpret mode
    and interpret mode never runs on the GPU."""
    from crychic_renderer_tpu.app.renderer import choose_rasterizer
    from crychic_renderer_tpu.config import RenderConfig

    assert rp.kernel_for_backend("gpu") is True
    assert rp.kernel_for_backend("cpu") is False
    with pytest.raises(ValueError, match="no rasterizer"):
        rp.kernel_for_backend("metal")

    auto = RenderConfig()
    assert choose_rasterizer(auto, "gpu").use_pallas is True
    assert choose_rasterizer(auto, "cpu").use_pallas is False
    with pytest.raises(ValueError):
        choose_rasterizer(auto, "metal")
    kern = dataclasses.replace(auto, use_pallas=True)
    with pytest.raises(ValueError, match="interpret"):
        choose_rasterizer(kern, "cpu")
    interp = dataclasses.replace(kern, pallas_interpret=True)
    assert choose_rasterizer(interp, "cpu").use_pallas is True
    with pytest.raises(ValueError, match="CPU tests"):
        choose_rasterizer(interp, "gpu")
    xla = dataclasses.replace(auto, use_pallas=False)
    assert choose_rasterizer(xla, "gpu").use_pallas is False


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_reference(gpu_backend):
    """On the card: the compiled kernel (not the interpreter) against the
    XLA reference on the same snapped triangles."""
    W, H = 512, 256
    vb, ib = _random_scene(T=400, seed=5)
    tris = rz.setup_triangles(vb, ib, W, H)
    d_k, t_k = jax.jit(lambda t: rp.rasterize_pallas(t, W, H, 1 << 16))(tris)
    bins = rz.bin_triangles(tris, W, H, 1 << 16)
    d_x, t_x = rz.rasterize_binned(tris, bins, W, H,
                                   -(-int(bins.counts.max()) // 32) * 32)
    d_k, t_k, d_x, t_x = map(np.asarray, (d_k, t_k, d_x, t_x))
    same = t_k == t_x
    assert same.mean() > 0.995
    np.testing.assert_allclose(d_k[same], d_x[same], atol=2e-4)


def test_windowed_pcf_row_major_extraction():
    """The row-major superwindow + exact 8-row y-extraction must agree
    with the direct (unwindowed) Poisson PCF on u16-quantized maps."""
    from crychic_renderer_tpu.ops import shadows as sh

    rng = np.random.default_rng(7)
    S = 64
    maps = rng.random((4, S, S), np.float32)
    maps[:, :24, :] = 1.0
    maps[:, 40:, :] = 0.0
    # quantize like superwindow_maps_u16 so both paths compare equal bits
    mq = np.round(np.clip(maps, 0, 1) * 65535.0) / 65535.0
    swin = sh.superwindow_maps_u16(jnp.asarray(maps))

    H, W = 24, 32
    u = rng.uniform(0.15, 0.85, (H, W)).astype(np.float32)
    v = rng.uniform(0.15, 0.85, (H, W)).astype(np.float32)
    d = rng.uniform(0.1, 0.9, (H, W)).astype(np.float32)
    # keep receiver depths off the u16 half-ULP comparison boundary so
    # the integer-compare (windowed) and float-compare (direct) agree
    d = ((np.floor(d * 65535.0) + 0.75) / 65535.0).astype(np.float32)
    pos = jnp.asarray(np.stack([u, v, d, np.ones_like(u)], -1))
    casc = jnp.asarray(rng.integers(0, 4, (H, W)).astype(np.int32))

    f_win = np.asarray(sh.poisson_pcf_windowed(swin, casc, pos, S))
    f_ref = np.asarray(sh.poisson_pcf(jnp.asarray(mq), casc, pos, S))
    np.testing.assert_allclose(f_win, f_ref, atol=2e-5)
