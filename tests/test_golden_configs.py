"""Committed golden images for ALL 5 BASELINE configs + per-pass goldens
(without them a regression confined to config-5 content — anisotropy,
animated textures, car/skull materials — or to a single pass would be
invisible to CI).

Coverage:
- configs 1-3 at 1/4 scale (the `app.compare --small` raster), configs
  4-5 at 1/8 scale (same content — cascades, SSAO, anisotropy, animated
  slots — at 1/4 the test cost; the full-scene CPU render at 1/4 scale
  is ~130 s, too slow for every suite run);
- per-pass goldens for config 4: cascade-0 shadow map and the blurred
  SSAO access map, pinning the shadow and SSAO pipelines individually.

All goldens are uint8-quantized and npz-compressed. Regenerate
deliberately with  GOLDEN_UPDATE=1 python -m pytest tests/test_golden_configs.py
"""
import dataclasses
import functools
import os
import pathlib

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"

# config -> resolution divisor (see module doc)
_SCALE = {1: 4, 2: 4, 3: 4, 4: 8, 5: 8}


def _u8(img):
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _check_golden(name, img8, frac=0.005):
    path = GOLDEN_DIR / f"{name}.npz"
    if os.environ.get("GOLDEN_UPDATE"):
        GOLDEN_DIR.mkdir(exist_ok=True)
        np.savez_compressed(path, img=img8)
        pytest.skip(f"golden written to {path}")
    # a missing golden is a FAILURE, not an invitation to self-bless: the
    # current (possibly regressed) render must never silently become the
    # new reference (only GOLDEN_UPDATE=1 writes)
    assert path.exists(), (
        f"golden {path} missing — restore it from git, or regenerate "
        f"deliberately with GOLDEN_UPDATE=1")
    ref = np.load(path)["img"]
    assert ref.shape == img8.shape, (ref.shape, img8.shape)
    diff = np.abs(img8.astype(np.int16) - ref.astype(np.int16))
    frac_visible = (diff > 5).mean()  # > ~2% intensity
    assert frac_visible < frac, (
        f"{name}: {frac_visible:.4%} of pixels moved >2% vs golden "
        f"(max diff {diff.max()}); if intentional, GOLDEN_UPDATE=1")


def _small_renderer(c):
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.app.renderer import Renderer

    k = _SCALE[c]
    scene, cfg, lights = CONFIGS[c]()
    cfg = dataclasses.replace(
        cfg, width=cfg.width // k, height=cfg.height // k,
        shadow_map_size=max(cfg.shadow_map_size // k, 128))
    return Renderer(scene, cfg, lights=lights)


@pytest.mark.slow
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_golden_baseline_config(c):
    r = _small_renderer(c)
    _check_golden(f"config{c}", _u8(r.render_np(0.0)))


@pytest.fixture(scope="module")
def cfg4_setup():
    r = _small_renderer(4)
    return r, r.device_scene, r.frame_constants(0.0), r.cfg


@pytest.mark.slow
def test_golden_config4_shadow_cascade0(cfg4_setup):
    """Pass golden: cascade-0 depth map (shadow fitting + depth-only
    raster + bias, isolated from the shading that consumes it)."""
    import jax
    from crychic_renderer_tpu.passes import frame as fr

    r, scene, consts, cfg = cfg4_setup
    smaps = np.asarray(jax.jit(functools.partial(
        fr.render_shadow_maps, cfg=cfg))(scene, consts))
    assert np.isfinite(smaps).all()
    _check_golden("config4_shadow_c0", _u8(smaps[0]))


@pytest.mark.slow
def test_golden_config4_ssao_access(cfg4_setup):
    """Pass golden: the blurred half-res SSAO access map (normal/depth
    resolve -> occlusion -> bilateral blurs, isolated)."""
    import jax
    from crychic_renderer_tpu.ops import rasterizer as rz
    from crychic_renderer_tpu.passes import frame as fr

    r, scene, consts, cfg = cfg4_setup

    def access_fn(scene, consts):
        tris, tri_attr = fr.main_view_tris(scene, consts, cfg)
        bins = rz.bin_triangles(tris, cfg.width, cfg.height,
                                cfg.pair_capacity)
        depth, tid = rz.rasterize_binned(tris, bins, cfg.width, cfg.height,
                                         cfg.bin_cap)
        g = fr.resolve_gbuffer(scene, consts, cfg, tris, depth, tid,
                               tri_attr)
        return fr.ssao_pass(scene, consts, cfg, g["normal_v"], depth)

    acc = np.asarray(jax.jit(access_fn)(scene, consts))
    assert np.isfinite(acc).all()
    _check_golden("config4_ssao_access", _u8(acc))


@pytest.mark.slow
@pytest.mark.parametrize("c", [4, 5])
def test_golden_fast_preset(c):
    """The --fast preset's IMAGE is pinned too. The
    golden is generated with cfg.fast_preset() — the one shared preset
    definition — so a preset-definition drift or a fast-path regression
    both show up here. The preset's distance FROM parity at native 1080p
    is not measured yet (ROADMAP S7)."""
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.app.renderer import Renderer

    k = _SCALE[c]
    scene, cfg, lights = CONFIGS[c]()
    cfg = dataclasses.replace(
        cfg, width=cfg.width // k, height=cfg.height // k,
        shadow_map_size=max(cfg.shadow_map_size // k, 128)).fast_preset()
    rf = Renderer(scene, cfg, lights=lights)
    _check_golden(f"config{c}_fast", _u8(rf.render_np(0.0)))


@pytest.mark.slow
def test_golden_config5_animated_frame():
    """Config 5 at t=0.1s (animation frame 3 of the 15-frame cycle; 0.5s
    would land exactly on a full cycle): the BoltAnim/FireAnim material
    slots have cycled (Renderer._animate_materials rewrites
    material->pair indices), pinning the animated-texture path that the
    t=0 golden cannot see."""
    r = _small_renderer(5)
    img0 = r.render_np(0.0)
    img1 = r.render_np(0.1)
    # the animation must actually change pixels (the bolt box region)
    assert np.abs(img1 - img0).max() > 0.02
    _check_golden("config5_anim_t01", _u8(img1))
