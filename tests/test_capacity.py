"""Rasterizer capacity guards: auto-sizing + overflow detection (no
silent triangle drops)."""
import dataclasses

import pytest

from crychic_renderer_tpu.config import RenderConfig
from crychic_renderer_tpu.models.scene import build_cascade_scene
from crychic_renderer_tpu.app.renderer import Renderer


def _cfg(**kw):
    base = dict(width=256, height=128, shadow_map_size=128,
                pair_capacity=1 << 16, bin_cap=256,
                shadow_pair_capacity=1 << 16, shadow_bin_cap=256,
                use_pallas=False, ssao_enabled=False)
    base.update(kw)
    return RenderConfig(**base)


def test_autosize_covers_requirements():
    r = Renderer(build_cascade_scene(), _cfg())
    req = r.check_capacity(0.0)  # must not raise
    assert r.cfg.pair_capacity >= 2 * req["main_pairs"]
    assert r.cfg.shadow_pair_capacity >= 2 * req["shadow_pairs"]
    assert r.cfg.bin_cap >= req["main_max_tile"]


def test_overflow_raises_instead_of_silent_drop():
    r = Renderer(build_cascade_scene(), _cfg(pair_capacity=16),
                 auto_capacity=False)
    with pytest.raises(RuntimeError, match="overflow"):
        r.check_capacity(0.0)


def test_shadow_overflow_raises():
    r = Renderer(build_cascade_scene(), _cfg(shadow_pair_capacity=16),
                 auto_capacity=False)
    with pytest.raises(RuntimeError, match="shadow raster overflow"):
        r.check_capacity(0.0)


def test_shade_tiles_count_alpha_layer():
    """alpha_merge_main sets tid >= 0 in tiles no OPAQUE bbox touches
    (fence bars against sky), so shade-tile occupancy must include the
    AT layer's bboxes — else the compacted resolve clear-fills covered
    alpha pixels without tripping check_capacity."""
    import functools

    import jax

    from crychic_renderer_tpu.models.scenes_baseline import fence_scene
    from crychic_renderer_tpu.passes import frame as fr

    scene, cfg, lights = fence_scene(alpha_test=True)
    r = Renderer(scene, cfg, lights=lights)
    # look UP at the fence so its bars land on pure-sky tiles the floor's
    # bboxes never touch
    r.camera.look_at((0.0, 2.0, -14.0), (0.0, 6.0, 0.0), (0.0, 1.0, 0.0))
    consts = r.frame_constants(0.0)
    req = jax.jit(functools.partial(
        fr.capacity_requirements, cfg=r.cfg))(r.device_scene, consts)
    cfg_off = dataclasses.replace(r.cfg, alpha_test_enabled=False)
    req_off = jax.jit(functools.partial(
        fr.capacity_requirements, cfg=cfg_off))(r.device_scene, consts)
    assert int(req["shade_tiles"]) > int(req_off["shade_tiles"]), (
        int(req["shade_tiles"]), int(req_off["shade_tiles"]))


def test_ssao_compaction_bit_exact():
    """Tile-compacted SSAO occlusion == the full-grid pass on the WHOLE
    access map (sky tiles' true occlusion is 1.0 — see
    _ssao_occlusion_compacted) to fp-folding noise (<= 1e-5; the
    full-grid path's constant pixel uv folds through the ray FMAs
    differently than the compacted runtime uv), with a camera pitched up
    so a band of pure-sky tiles is actually skipped."""
    import functools

    import jax
    import numpy as np

    from crychic_renderer_tpu.passes import frame as fr
    from crychic_renderer_tpu.ops import rasterizer as rz

    r = Renderer(build_cascade_scene(),
                 _cfg(width=768, height=256, ssao_enabled=True,
                      shadows_enabled=True, shadow_map_size=256,
                      shadow_pair_capacity=1 << 17, shadow_bin_cap=512))
    r.camera.look_at((0.0, 4.0, -20.0), (0.0, 10.0, 0.0), (0.0, 1.0, 0.0))
    r._autosize_capacity()
    cfg = r.cfg
    assert cfg.ssao_tile_capacity, cfg
    req = r.check_capacity(0.0)
    nt = (-(-cfg.ssao_height // fr.SHADE_TILE_H)
          * -(-cfg.ssao_width // fr.SHADE_TILE_W))
    assert req["ssao_tiles"] < nt, (req["ssao_tiles"], nt)

    scene, consts = r.device_scene, r.frame_constants(0.0)

    def access(scene, consts, cfg):
        tris, tri_attr = fr.main_view_tris(scene, consts, cfg)
        bins = rz.bin_triangles(tris, cfg.width, cfg.height,
                                cfg.pair_capacity)
        depth, tid = rz.rasterize_binned(tris, bins, cfg.width,
                                         cfg.height, cfg.bin_cap)
        g = fr.resolve_gbuffer(scene, consts, cfg, tris, depth, tid,
                               tri_attr)
        return fr.ssao_pass(scene, consts, cfg, g["normal_v"], depth,
                            valid=tid >= 0)

    a_comp = np.asarray(jax.jit(functools.partial(
        access, cfg=cfg))(scene, consts))
    cfg_full = dataclasses.replace(cfg, ssao_tile_capacity=None)
    a_full = np.asarray(jax.jit(functools.partial(
        access, cfg=cfg_full))(scene, consts))
    np.testing.assert_allclose(a_comp, a_full, atol=1e-5, rtol=0)
    # the skipped-tile region must be the exact 1.0 fill == true value
    assert (a_comp == a_full).mean() > 0.5

    # and the FULL frame (compacted resolve + SSAO + PCF factor) matches
    # the dense path to fp-folding noise
    img_c = np.asarray(jax.jit(functools.partial(
        fr.render_frame, cfg=cfg))(scene, consts))
    cfg_dense = dataclasses.replace(cfg, shade_tile_capacity=None,
                                    ssao_tile_capacity=None)
    img_d = np.asarray(jax.jit(functools.partial(
        fr.render_frame, cfg=cfg_dense))(scene, consts))
    np.testing.assert_allclose(img_c, img_d, atol=1e-5, rtol=0)


def test_ssao_tile_overflow_raises():
    r = Renderer(build_cascade_scene(), _cfg(ssao_enabled=True))
    r.cfg = dataclasses.replace(r.cfg, ssao_tile_capacity=1)
    with pytest.raises(RuntimeError, match="ssao tile overflow"):
        r.check_capacity(0.0)


def test_ensure_capacity_grows_and_recompiles():
    """ensure_capacity: a pose that outruns the 1.25x tile headroom must
    GROW the capacities (re-autosize + rebind) instead of raising, and
    the regrown renderer must pass check_capacity."""
    r = Renderer(build_cascade_scene(), _cfg(ssao_enabled=True))
    # cripple the capacities so the initial pose overflows
    r.cfg = dataclasses.replace(r.cfg, pair_capacity=16)
    r.rebind_frame_fn()
    with pytest.raises(RuntimeError):
        r.check_capacity(0.0)
    req = r.ensure_capacity(0.0)
    assert r.cfg.pair_capacity >= req["main_pairs"]
    r.check_capacity(0.0)  # must not raise
