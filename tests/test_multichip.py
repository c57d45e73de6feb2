"""Sharded-frame tests on the virtual 8-device CPU mesh."""
import dataclasses
import functools

import numpy as np
import jax
import pytest


def test_dryrun_multichip_entry():
    import __graft_entry__ as ge

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [16, 32, 64])
def test_dryrun_at_scaling_table_device_counts(n_dev):
    """The full dryrun (XLA 1080-row + kernel band + replica axis — at
    n_dev=64 the replica leg is a 2x32 mesh) at large device counts.
    Needs its own interpreter: the virtual device count is fixed at
    backend init, so this spawns a subprocess with a larger mesh."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    env["JAX_PLATFORMS"] = "cpu"
    # run from the repo root so __graft_entry__/crychic_renderer_tpu
    # resolve regardless of pytest's invocation directory
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; g.dryrun_multichip({n_dev})"],
        env=env, cwd=repo_root, capture_output=True, text=True,
        timeout=1500)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "kernel band ok" in out.stdout, out.stdout
    assert "replica axis ok" in out.stdout, out.stdout


def _small_scene_and_cfg(with_alpha=False, **cfg_overrides):
    from crychic_renderer_tpu.config import RenderConfig
    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.models import geometry as gg
    from crychic_renderer_tpu.models.materials import Material
    from crychic_renderer_tpu.models.scenes_baseline import _scene_from_items
    from crychic_renderer_tpu.models.scene import (LAYER_OPAQUE,
                                                   LAYER_ALPHA_TESTED,
                                                   make_item)
    from crychic_renderer_tpu.utils import mathutil as mu

    base = dict(width=256, height=64, shadow_map_size=128,
                ssao_enabled=True, use_pallas=False,
                pair_capacity=1 << 16, bin_cap=1024,
                shadow_pair_capacity=1 << 16, shadow_bin_cap=1024)
    if with_alpha:
        base.update(alpha_test_enabled=True, alpha_shadow_window=64)
    base.update(cfg_overrides)
    cfg = RenderConfig(**base)
    # NOTE: bin_cap must exceed the busiest tile's triangle count (the XLA
    # raster path truncates at bin_cap); a fight-free scene keeps the
    # comparison exact.
    mats = [Material("m0", 0, 0, 1, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.4),
            Material("fence", 1, 2, 3, (1, 1, 1, 1), (0.1, 0.1, 0.1), 0.3)]
    items = [
        make_item("box", gg.create_box(2, 2, 2, 1), LAYER_OPAQUE,
                  mu.translation(0.0, 1.3, 0.0)),
        make_item("grid", gg.create_grid(20, 20, 20, 20), LAYER_OPAQUE),
    ] + ([make_item("fence", gg.create_box(3, 3, 3, 0),
                    LAYER_ALPHA_TESTED, mu.translation(3.0, 1.5, -2.0),
                    material_indices=1)] if with_alpha else [])
    scene = _scene_from_items(items, mats, [
        "bricks2", "bricks2_nmap", "WireFence", "default_nmap",
        "white1x1", "default_nmap", "sky_cube", "default_nmap",
        "white1x1", "white1x1"])
    r = Renderer(scene, cfg)
    return r, r.cfg


def _compare_sharded(cfg, r, n_dev, tight=None):
    from crychic_renderer_tpu.parallel import sharded
    from crychic_renderer_tpu.passes import frame as fr

    consts = r.frame_constants(0.0)
    single = np.asarray(
        jax.jit(functools.partial(fr.render_frame, cfg=cfg))(
            r.device_scene, consts))

    mesh = sharded.make_mesh(n_dev)
    multi = np.asarray(jax.jit(functools.partial(
        sharded.render_frame_sharded, cfg=cfg, mesh=mesh))(
            r.device_scene, consts))

    assert multi.shape == single.shape
    # Band rendering rasterizes each device's tile rows with GLOBAL tile
    # anchors (identical fp math to single-chip) and resolves with a halo
    # row for seam derivatives, so the sharded frame matches single-chip
    # up to XLA fusion/FMA association noise — which discrete comparisons
    # (a PCF tap at a texel boundary) can amplify to an isolated-pixel
    # flip. `tight` additionally asserts a hard max-diff bound.
    diff = np.abs(multi - single).max(axis=-1)
    if tight is not None:
        assert diff.max() < tight, f"max diff {diff.max():.6f} >= {tight}"
    visible = diff > 0.02
    assert visible.mean() < 1e-3, f"visible mismatch {visible.mean():.4f}"


@pytest.mark.slow
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_matches_single_device(n_dev):
    """The sharded frame equals the single-device frame for device counts
    below, equal to, and above num_cascades — with SSAO enabled."""
    r, cfg = _small_scene_and_cfg()
    _compare_sharded(cfg, r, n_dev)


@pytest.mark.slow
def test_sharded_pallas_kernel_matches_single():
    """The sharded path runs the SAME raster kernel the single-card frame
    uses (interpret mode on CPU), including the shadow atlas."""
    r, cfg = _small_scene_and_cfg(use_pallas=True, pallas_interpret=True,
                                  ssao_enabled=False)
    _compare_sharded(cfg, r, 2)


@pytest.mark.slow
def test_sharded_alpha_layer_matches_single():
    """Band rendering applies the AlphaTested peel + shadow punch with
    global pixel rows — identical to the single-chip merge."""
    r, cfg = _small_scene_and_cfg(with_alpha=True)
    _compare_sharded(cfg, r, 4)


@pytest.mark.slow
def test_sharded_fast_preset_matches_single():
    """The performance preset (half-res PCF factor + quarter-res SSAO)
    composes with band sharding BAND-EXACTLY: the half-res factor is
    evaluated at global phase and upsampled from the all-gathered full
    map, so no seams at band boundaries."""
    r, cfg = _small_scene_and_cfg(fast_shadow_factor=True, ssao_scale=4,
                                  aniso_probes=2)
    _compare_sharded(cfg, r, 4, tight=1e-3)


@pytest.mark.slow
def test_sharded_forward_debug_quad_matches_single():
    """The forward branch's always-on shadow-map debug quad
    (CRYCHIC.cpp:406-407) is drawn at global row phase in the band path,
    so forward+shadows configs stay band-exact across the quad seam."""
    r, cfg = _small_scene_and_cfg(deferred=False, ssao_enabled=False)
    assert cfg.shadows_enabled and not cfg.deferred
    _compare_sharded(cfg, r, 4)


@pytest.mark.slow
def test_sharded_odd_bands_padding():
    """Heights that do NOT divide across devices (the 1080/8 headline
    wall): 60 rows over 8 devices pad to 8x8-row
    bands and the pad rows are cropped."""
    r, cfg = _small_scene_and_cfg(height=60)
    _compare_sharded(cfg, r, 8)


@pytest.mark.slow
def test_sharded_fast_preset_odd_band_exact():
    """The fast preset composes with a non-dividing height (15-row bands
    pad to 16) and stays band-exact at the tight bound."""
    r, cfg = _small_scene_and_cfg(height=60, fast_shadow_factor=True,
                                  ssao_scale=4, aniso_probes=2)
    _compare_sharded(cfg, r, 4, tight=1e-3)


@pytest.mark.slow
def test_replicated_frames_match_single():
    """The replica axis (2D (rep, band) mesh, data-parallel frames in
    flight) renders each replica's frame identically to the single-chip
    render of that frame — two different camera times, each band-sharded
    2 ways on a 2x2 virtual mesh, one dispatch."""
    import functools
    import jax.numpy as jnp
    from crychic_renderer_tpu.parallel import sharded
    from crychic_renderer_tpu.passes import frame as fr

    r, cfg = _small_scene_and_cfg()
    c0 = r.frame_constants(0.0)
    r.camera.walk(2.0)
    r.camera.rotate_y(0.1)
    c1 = r.frame_constants(0.5)
    single = [
        np.asarray(jax.jit(functools.partial(fr.render_frame, cfg=cfg))(
            r.device_scene, c)) for c in (c0, c1)]

    mesh = sharded.make_mesh2(2, 2)
    scenes = sharded.stack_frames([r.device_scene, r.device_scene])
    consts = sharded.stack_frames([c0, c1])
    multi = np.asarray(jax.jit(functools.partial(
        sharded.render_frames_replicated, cfg=cfg, mesh=mesh))(
            scenes, consts))

    assert multi.shape == (2, cfg.height, cfg.width, 4)
    assert not np.allclose(single[0], single[1])  # frames really differ
    for i in range(2):
        diff = np.abs(multi[i] - single[i]).max(axis=-1)
        assert (diff > 0.02).mean() < 1e-3


def test_check_band_capacity_guard():
    """check_band_capacity passes at autosized capacities and raises when
    a device's pair load exceeds the band capacity (the sharded mirror of
    the viewer's per-frame overflow guard)."""
    from crychic_renderer_tpu.parallel import sharded

    r, cfg = _small_scene_and_cfg()
    consts = r.frame_constants(0.0)
    cfg2 = sharded.autosize_band_capacities(r.device_scene, consts, cfg, 4)
    req = sharded.check_band_capacity(r.device_scene, consts, cfg2, 4)
    assert req["main_band_pairs"] <= req["main_band_capacity"]

    tiny = dataclasses.replace(cfg2, band_pair_capacity=32)
    with pytest.raises(RuntimeError, match="main raster overflow"):
        sharded.check_band_capacity(r.device_scene, consts, tiny, 4)
    tiny_s = dataclasses.replace(cfg2, shadow_band_pair_capacity=32)
    with pytest.raises(RuntimeError, match="shadow raster overflow"):
        sharded.check_band_capacity(r.device_scene, consts, tiny_s, 4)


def test_band_restricted_binning_is_exact():
    """bin_triangles(ty_lo, num_rows) produces, for every in-band tile,
    the same run contents in the same order as full-screen binning — the
    rasterized band is bit-equal to the corresponding full-screen rows."""
    from crychic_renderer_tpu.ops import rasterizer as rz
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    W, H = 256, 96
    T = 200
    xy = rng.uniform(-1.2, 1.2, (T, 3, 2))
    z = rng.uniform(0.05, 0.95, (T, 3))
    w = np.ones((T, 3, 1), np.float32)
    clip = np.concatenate([xy * w, z[..., None] * w, w], -1).astype(
        np.float32)
    tris = rz.setup_tri_verts(jnp.asarray(clip), None, W, H)
    full = rz.bin_triangles(tris, W, H, 1 << 14)
    d_full, t_full = rz.rasterize_binned(tris, full, W, H, 256)
    for tr0, nr in [(0, 2), (1, 2), (2, 1)]:
        bb = rz.bin_triangles(tris, W, H, 1 << 13, ty_lo=tr0, num_rows=nr)
        d, t = rz.rasterize_binned(tris, bb, W, H, 256,
                                   tile_row_offset=tr0, num_tile_rows=nr)
        r0 = tr0 * rz.TILE_H
        r1 = min((tr0 + nr) * rz.TILE_H, H)
        assert np.array_equal(np.asarray(d)[:r1 - r0],
                              np.asarray(d_full)[r0:r1])
        assert np.array_equal(np.asarray(t)[:r1 - r0],
                              np.asarray(t_full)[r0:r1])


@pytest.mark.slow
def test_sharded_autosized_band_capacity_matches():
    """autosize_band_capacities sizes the per-band binning from EXACT
    worst-band pair counts (pair distribution across bands is heavily
    skewed — a 1/n_dev split silently drops geometry); the tightened
    config still matches single-chip."""
    from crychic_renderer_tpu.parallel import sharded

    r, cfg = _small_scene_and_cfg()
    consts = r.frame_constants(0.0)
    req = sharded.band_requirements(r.device_scene, consts, cfg, 4)
    cfg2 = sharded.autosize_band_capacities(r.device_scene, consts, cfg, 4)
    assert cfg2.band_pair_capacity >= int(req["main_band_pairs"])
    assert cfg2.shadow_band_pair_capacity >= int(req["shadow_band_pairs"])
    assert cfg2.band_pair_capacity <= cfg.pair_capacity
    _compare_sharded(cfg2, r, 4)


def test_interleaved_binning_is_exact():
    """row_stride=(n, d) binning + raster produces, for every owned tile
    row, output bit-equal to full-screen binning — on BOTH rasterizer
    paths (the owner-major key permutation must not perturb run contents,
    order, or tile anchors)."""
    from crychic_renderer_tpu.ops import rasterizer as rz
    from crychic_renderer_tpu.ops import raster_pallas as rp
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    W, H = 256, 96
    T = 300
    xy = rng.uniform(-1.2, 1.2, (T, 3, 2))
    z = rng.uniform(0.05, 0.95, (T, 3))
    w = np.ones((T, 3, 1), np.float32)
    clip = np.concatenate([xy * w, z[..., None] * w, w], -1).astype(
        np.float32)
    tris = rz.setup_tri_verts(jnp.asarray(clip), None, W, H)
    n = 4

    full_bins = rz.bin_triangles(tris, W, H, 1 << 14)
    d_full, t_full = rz.rasterize_binned(tris, full_bins, W, H, 256)
    nty = -(-H // rz.TILE_H)
    for d in range(n):
        bb = rz.bin_triangles(tris, W, H, 1 << 13, row_stride=(n, d))
        dd, tt = rz.rasterize_binned(tris, bb, W, H, 256,
                                     row_stride=(n, d))
        for s in range(-(-nty // n)):
            ty = s * n + d
            if ty >= nty:
                continue
            r0, r1 = ty * rz.TILE_H, min((ty + 1) * rz.TILE_H, H)
            sl = slice(s * rz.TILE_H, s * rz.TILE_H + (r1 - r0))
            assert np.array_equal(np.asarray(dd)[sl],
                                  np.asarray(d_full)[r0:r1])
            assert np.array_equal(np.asarray(tt)[sl],
                                  np.asarray(t_full)[r0:r1])

    dp_full, tp_full = rp.rasterize_pallas(tris, W, H, 1 << 14,
                                           interpret=True)
    th = rp.TILE_H
    nty_k = -(-H // th)
    for d in range(n):
        dd, tt = rp.rasterize_pallas(tris, W, H, 1 << 13, interpret=True,
                                     row_stride=(n, d))
        for s in range(-(-nty_k // n)):
            ty = s * n + d
            if ty >= nty_k:
                continue
            r0, r1 = ty * th, min((ty + 1) * th, H)
            sl = slice(s * th, s * th + (r1 - r0))
            assert np.array_equal(np.asarray(dd)[sl],
                                  np.asarray(dp_full)[r0:r1])
            assert np.array_equal(np.asarray(tt)[sl],
                                  np.asarray(tp_full)[r0:r1])
