"""Texture pair-pool sampling tests: addressing, small-class LOD,
anisotropic filtering."""
import numpy as np
import jax.numpy as jnp

from crychic_renderer_tpu.ops import sampling


def _solid(size, rgba):
    return [np.full((size, size, 4), rgba, np.uint8)]


def _checker(size):
    """1-texel checkerboard: mip 0 alternates 0/255, mip 1+ is ~128."""
    y, x = np.mgrid[:size, :size]
    v = ((x + y) % 2 * 255).astype(np.uint8)
    img = np.stack([v, v, v, np.full_like(v, 255)], axis=-1)
    return [img]


def test_pair_pool_addressing():
    pool = sampling.PairPool.build(
        [(_solid(512, (255, 0, 0, 255)), _solid(512, (0, 0, 255, 255))),
         (_solid(64, (0, 255, 0, 255)), _solid(64, (255, 255, 0, 255)))],
        n_big=1)
    uv = jnp.asarray([[0.3, 0.7]])
    for mip in [0, 3]:
        d, n = sampling.sample_pair_bilinear(
            pool, jnp.asarray([0]), uv, jnp.asarray([mip]))
        np.testing.assert_allclose(np.asarray(d)[0], [1, 0, 0, 1], atol=0.01)
        np.testing.assert_allclose(np.asarray(n)[0], [0, 0, 1, 1], atol=0.01)
    d, n = sampling.sample_pair_bilinear(
        pool, jnp.asarray([1]), uv, jnp.asarray([0]))
    np.testing.assert_allclose(np.asarray(d)[0], [0, 1, 0, 1], atol=0.01)
    np.testing.assert_allclose(np.asarray(n)[0], [1, 1, 0, 1], atol=0.01)


def test_small_class_lod_samples_mip0_at_1to1():
    """A 64^2 texture sampled at 1:1 screen scale (uv
    footprint 1/64 per pixel) must read mip 0 — the round-1 pool scaled
    derivatives by the BIG class size (512), overestimating small-class
    LOD by 3 levels (8x blur)."""
    pool = sampling.PairPool.build(
        [(_checker(512), _checker(512)), (_checker(64), _checker(64))],
        n_big=1)
    # texel-center samples of the small texture at 1:1 scale
    ij = (np.arange(8) + 0.5) / 64.0
    uv = jnp.asarray(np.stack([ij, ij], axis=-1))
    lod_uv = jnp.full((8,), np.log2(1.0 / 64.0), jnp.float32)
    d, _ = sampling.sample_pair_trilinear(pool, jnp.full((8,), 1), uv,
                                          lod_uv)
    vals = np.asarray(d)[:, 0]
    # mip 0 checker at texel centers is exactly 0 or 1; mip 3 would be ~0.5
    assert np.all((vals < 0.05) | (vals > 0.95)), vals

    # and the big class at ITS 1:1 scale (footprint 1/512) also reads mip 0
    ij = (np.arange(8) + 0.5) / 512.0
    uv = jnp.asarray(np.stack([ij, ij], axis=-1))
    lod_uv = jnp.full((8,), np.log2(1.0 / 512.0), jnp.float32)
    d, _ = sampling.sample_pair_trilinear(pool, jnp.zeros(8, jnp.int32), uv,
                                          lod_uv)
    vals = np.asarray(d)[:, 0]
    assert np.all((vals < 0.05) | (vals > 0.95)), vals


def test_aniso_matches_trilinear_when_isotropic():
    rng = np.random.default_rng(0)
    img = [rng.integers(0, 255, (512, 512, 4), dtype=np.uint8)]
    pool = sampling.PairPool.build([(img, img)], n_big=1)
    uv = jnp.asarray(rng.random((16, 2)), jnp.float32)
    # isotropic footprint of 4 texels -> lod 2
    d = jnp.full((16, 2), 0.0, jnp.float32).at[:, 0].set(4.0 / 512.0)
    dy = jnp.full((16, 2), 0.0, jnp.float32).at[:, 1].set(4.0 / 512.0)
    pair = jnp.zeros(16, jnp.int32)
    da, na = sampling.sample_pair_aniso(pool, pair, uv, d, dy, 8)
    dt, nt = sampling.sample_pair_trilinear(
        pool, pair, uv, sampling.lod_from_derivatives(d, dy))
    np.testing.assert_allclose(np.asarray(da), np.asarray(dt), atol=1e-5)
    np.testing.assert_allclose(np.asarray(na), np.asarray(nt), atol=1e-5)


def test_aniso_sharper_than_trilinear_at_grazing():
    """At an 8:1 anisotropic footprint, the aniso sample must resolve
    detail the trilinear sample blurs away: sample a vertical-stripe
    texture with a footprint wide in x... stripes along x vary, so use
    footprint elongated in Y over stripes varying in X: trilinear picks
    lod from the MAJOR axis (blurry), aniso from the minor (sharp)."""
    x = np.arange(512)
    v = ((x // 4 % 2) * 255).astype(np.uint8)  # 4-texel vertical stripes
    img = [np.broadcast_to(
        np.stack([v, v, v, np.full_like(v, 255)], -1)[None],
        (512, 512, 4)).copy()]
    pool = sampling.PairPool.build([(img, img)], n_big=1)
    n = 16
    uv = jnp.asarray(
        np.stack([(np.arange(n) * 4 + 2.0) / 512.0,
                  np.full(n, 0.5)], axis=-1), jnp.float32)
    dx = jnp.tile(jnp.asarray([[1.0 / 512.0, 0.0]]), (n, 1))   # 1 texel
    dy = jnp.tile(jnp.asarray([[0.0, 8.0 / 512.0]]), (n, 1))   # 8 texels
    pair = jnp.zeros(n, jnp.int32)
    da, _ = sampling.sample_pair_aniso(pool, pair, uv, dx, dy, 8)
    dt, _ = sampling.sample_pair_trilinear(
        pool, pair, uv, sampling.lod_from_derivatives(dx, dy))
    # stripes run along y: the aniso footprint (long in y) preserves the
    # x-contrast; trilinear lod = log2(8) washes it toward 0.5
    contrast_a = np.asarray(da)[:, 0].std()
    contrast_t = np.asarray(dt)[:, 0].std()
    assert contrast_a > contrast_t * 2.0, (contrast_a, contrast_t)
    assert contrast_a > 0.3, contrast_a


# ---------------------------------------------------------------------------
# Dual-mip rows
# ---------------------------------------------------------------------------

def test_dual_pool_prefix_matches_single():
    """Lanes 0:8 of a dual-mip pool are exactly the single-mip pool, so
    sample_pair_bilinear works unchanged on either layout."""
    rng = np.random.default_rng(3)
    img = [rng.integers(0, 255, (512, 512, 4), dtype=np.uint8)]
    img2 = [rng.integers(0, 255, (64, 64, 4), dtype=np.uint8)]
    pairs = [(img, img), (img2, img2)]
    p1 = sampling.PairPool.build(pairs, n_big=1)
    p2 = sampling.PairPool.build(pairs, n_big=1, dual=True)
    assert p2.data.shape[-1] == sampling.PAIR_ROW_DUAL
    np.testing.assert_array_equal(np.asarray(p1.data),
                                  np.asarray(p2.data[:, :8]))


def test_dual_trilinear_exact_on_nonneg_parent_frac():
    """sample_pair_dual's mip-(m+1) bilinear is EXACT whenever the stored
    midpoint-parent frac is >= 0 (odd child texels always; even child
    texels with fx >= 0.5): fx1 = fx/2 - 0.25 + 0.5*(x0 odd)."""
    rng = np.random.default_rng(7)
    img = [rng.integers(0, 255, (512, 512, 4), dtype=np.uint8)]
    pairs = [(img, img)]
    p1 = sampling.PairPool.build(pairs, n_big=1)
    p2 = sampling.PairPool.build(pairs, n_big=1, dual=True)
    # sample at x = texel_center + 0.75 (fx = 0.75 -> fx1 >= 0 for both
    # parities), arbitrary texels, fractional lod
    S = 256.0  # mip 1 grid
    base = rng.integers(0, 255, 64).astype(np.float32)
    uv = np.stack([(base + 0.5 + 0.75) / S, (base[::-1] + 0.5 + 0.75) / S],
                  axis=-1).astype(np.float32)
    lod_uv = np.full(64, np.log2(2.5 / 512.0), np.float32)  # lod ~1.32
    pair = jnp.zeros(64, jnp.int32)
    d1, n1 = sampling.sample_pair_trilinear(p1, pair, jnp.asarray(uv),
                                            jnp.asarray(lod_uv))
    d2, n2 = sampling.sample_pair_trilinear(p2, pair, jnp.asarray(uv),
                                            jnp.asarray(lod_uv))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=2e-6)
    np.testing.assert_allclose(np.asarray(n1), np.asarray(n2), atol=2e-6)


def test_dual_trilinear_bounded_on_smooth_mips():
    """On smooth content the midpoint-parent extrapolation error is tiny
    (it is bounded by 0.25x the parent mip's second difference)."""
    y, x = np.mgrid[:512, :512].astype(np.float32)
    # PERIODIC content (8 / 6 cycles over the 512 tile): material textures
    # tile, and the midpoint-parent quad wrap-addresses its +1 neighbor,
    # so a non-tiling test pattern would measure the wrap seam's content
    # discontinuity rather than the extrapolation bound
    v = (127.5 + 100 * np.sin(x * (8 * np.pi / 512))
         * np.cos(y * (6 * np.pi / 512))).astype(np.uint8)
    img = [np.stack([v, v, v, np.full_like(v, 255)], -1)]
    pairs = [(img, img)]
    p1 = sampling.PairPool.build(pairs, n_big=1)
    p2 = sampling.PairPool.build(pairs, n_big=1, dual=True)
    rng = np.random.default_rng(11)
    uv = jnp.asarray(rng.random((512, 2)), jnp.float32)
    # footprints of 1-4 texels (mips 0-2): there the parent mips still
    # resolve the ~125-texel sine period, i.e. content IS smooth relative
    # to texel spacing (at deeper mips the premise, and the bound's
    # usefulness, fade with the content itself)
    lod_uv = jnp.asarray(
        np.log2(rng.uniform(1.0, 4.0, 512) / 512.0), jnp.float32)
    pair = jnp.zeros(512, jnp.int32)
    d1, _ = sampling.sample_pair_trilinear(p1, pair, uv, lod_uv)
    d2, _ = sampling.sample_pair_trilinear(p2, pair, uv, lod_uv)
    assert np.abs(np.asarray(d1) - np.asarray(d2)).max() < 0.01


def test_dual_aniso_matches_trilinear_when_isotropic():
    rng = np.random.default_rng(13)
    img = [rng.integers(0, 255, (512, 512, 4), dtype=np.uint8)]
    pool = sampling.PairPool.build([(img, img)], n_big=1, dual=True)
    uv = jnp.asarray(rng.random((16, 2)), jnp.float32)
    d = jnp.full((16, 2), 0.0, jnp.float32).at[:, 0].set(4.0 / 512.0)
    dy = jnp.full((16, 2), 0.0, jnp.float32).at[:, 1].set(4.0 / 512.0)
    pair = jnp.zeros(16, jnp.int32)
    da, na = sampling.sample_pair_aniso(pool, pair, uv, d, dy, 8, probes=2)
    dt, nt = sampling.sample_pair_trilinear(
        pool, pair, uv, sampling.lod_from_derivatives(d, dy))
    np.testing.assert_allclose(np.asarray(da), np.asarray(dt), atol=1e-5)
    np.testing.assert_allclose(np.asarray(na), np.asarray(nt), atol=1e-5)


def test_aniso_ref_matches_exact_trilinear_when_isotropic():
    rng = np.random.default_rng(17)
    img = [rng.integers(0, 255, (512, 512, 4), dtype=np.uint8)]
    pool = sampling.PairPool.build([(img, img)], n_big=1)
    uv = jnp.asarray(rng.random((16, 2)), jnp.float32)
    d = jnp.full((16, 2), 0.0, jnp.float32).at[:, 0].set(4.0 / 512.0)
    dy = jnp.full((16, 2), 0.0, jnp.float32).at[:, 1].set(4.0 / 512.0)
    pair = jnp.zeros(16, jnp.int32)
    da, _ = sampling.sample_pair_aniso_ref(pool, pair, uv, d, dy, 8)
    dt, _ = sampling.sample_pair_trilinear(
        pool, pair, uv, sampling.lod_from_derivatives(d, dy))
    np.testing.assert_allclose(np.asarray(da), np.asarray(dt), atol=1e-5)


def test_dual_aniso_sharper_than_trilinear_at_grazing():
    x = np.arange(512)
    v = ((x // 4 % 2) * 255).astype(np.uint8)
    img = [np.broadcast_to(
        np.stack([v, v, v, np.full_like(v, 255)], -1)[None],
        (512, 512, 4)).copy()]
    pool = sampling.PairPool.build([(img, img)], n_big=1, dual=True)
    n = 16
    uv = jnp.asarray(
        np.stack([(np.arange(n) * 4 + 2.0) / 512.0,
                  np.full(n, 0.5)], axis=-1), jnp.float32)
    dx = jnp.tile(jnp.asarray([[1.0 / 512.0, 0.0]]), (n, 1))
    dy = jnp.tile(jnp.asarray([[0.0, 8.0 / 512.0]]), (n, 1))
    pair = jnp.zeros(n, jnp.int32)
    da, _ = sampling.sample_pair_aniso(pool, pair, uv, dx, dy, 8, probes=2)
    dt, _ = sampling.sample_pair_trilinear(
        pool, pair, uv, sampling.lod_from_derivatives(dx, dy))
    contrast_a = np.asarray(da)[:, 0].std()
    contrast_t = np.asarray(dt)[:, 0].std()
    assert contrast_a > contrast_t * 2.0, (contrast_a, contrast_t)
    assert contrast_a > 0.3, contrast_a
