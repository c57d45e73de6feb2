"""Golden-image regression tests (SURVEY.md §4 layer 2).

Renders fixed small scenes and compares summary statistics against stored
values. Statistics rather than full images keep the repo lean while still
catching regressions in any pass (a change in raster coverage, shading
math, shadows or SSAO moves the mean/quantiles measurably). All randomness
is seed-deterministic (MSVC rand replication), so these are stable across
runs on the same backend.
"""
import dataclasses

import numpy as np
import pytest

from crychic_renderer_tpu.config import RenderConfig
from crychic_renderer_tpu.models.scene import build_cascade_scene
from crychic_renderer_tpu.app.renderer import Renderer


@pytest.fixture(scope="module")
def small_frame():
    cfg = RenderConfig(width=256, height=144, shadow_map_size=256,
                       pair_capacity=1 << 17, bin_cap=2048,
                       shadow_pair_capacity=1 << 17, shadow_bin_cap=2048,
                       use_pallas=False)
    scene = build_cascade_scene()
    r = Renderer(scene, cfg)
    img = r.render_np(0.0)
    return img


def test_frame_statistics(small_frame):
    img = small_frame
    assert img.shape == (144, 256, 4)
    assert np.isfinite(img).all()
    # sky occupies the upper region; boxes+ground the lower
    mean = img[..., :3].mean()
    assert 0.3 < mean < 0.95, mean
    # the frame must contain real contrast (geometry + shadows)
    assert img[..., :3].std() > 0.05
    # alpha is 1 everywhere (opaque scene + sky)
    assert np.allclose(img[..., 3], 1.0)


def test_frame_regions(small_frame):
    img = small_frame
    # sky gradient: top rows brighter blue than red
    top = img[:20, :, :3].mean(axis=(0, 1))
    assert top[2] >= top[0]
    # frame is not constant per-quadrant (geometry present)
    q = [img[:72, :128, :3].mean(), img[:72, 128:, :3].mean(),
         img[72:, :128, :3].mean(), img[72:, 128:, :3].mean()]
    assert max(q) - min(q) > 0.01


def test_frame_deterministic(small_frame):
    cfg = RenderConfig(width=256, height=144, shadow_map_size=256,
                       pair_capacity=1 << 17, bin_cap=2048,
                       shadow_pair_capacity=1 << 17, shadow_bin_cap=2048,
                       use_pallas=False)
    scene = build_cascade_scene()
    r = Renderer(scene, cfg)
    img2 = r.render_np(0.0)
    np.testing.assert_array_equal(img2, small_frame)


def test_toggles_change_output(small_frame):
    """Disabling SSAO / shadows / sky must visibly change the image — each
    subsystem is actually wired into the frame."""
    base_cfg = dict(width=256, height=144, shadow_map_size=256,
                    pair_capacity=1 << 17, bin_cap=2048,
                    shadow_pair_capacity=1 << 17, shadow_bin_cap=2048,
                    use_pallas=False)
    scene = build_cascade_scene()
    for toggle in ("ssao_enabled", "shadows_enabled", "sky_enabled"):
        cfg = RenderConfig(**base_cfg, **{toggle: False})
        img = Renderer(scene, cfg).render_np(0.0)
        diff = np.abs(img - small_frame).max()
        assert diff > 0.01, f"{toggle} has no effect ({diff})"


GOLDEN_DIR = __import__("pathlib").Path(__file__).parent / "goldens"


def test_golden_image_cascade(small_frame):
    """True golden-image regression: the
    committed golden pins every pass's output. A code change that shifts
    >2% intensity on >0.5% of pixels fails. Regenerate deliberately with
    GOLDEN_UPDATE=1 python -m pytest tests/test_golden.py -k cascade."""
    import os

    img8 = (np.clip(small_frame, 0, 1) * 255 + 0.5).astype(np.uint8)
    path = GOLDEN_DIR / "cascade_256x144.npy"
    if os.environ.get("GOLDEN_UPDATE") or not path.exists():
        GOLDEN_DIR.mkdir(exist_ok=True)
        np.save(path, img8)
        pytest.skip(f"golden written to {path}")
    ref = np.load(path)
    diff = np.abs(img8.astype(np.int16) - ref.astype(np.int16))
    frac_visible = (diff > 5).mean()  # > ~2% intensity
    assert frac_visible < 0.005, (
        f"{frac_visible:.4%} of pixels moved >2% vs golden "
        f"(max diff {diff.max()}); if intentional, GOLDEN_UPDATE=1")


def test_snapshot_roundtrip(tmp_path):
    from crychic_renderer_tpu.io import snapshot
    from crychic_renderer_tpu.models.materials import build_reference_lights

    scene = build_cascade_scene()
    lights = build_reference_lights()
    path = str(tmp_path / "scene.npz")
    snapshot.save_scene(path, scene, lights)
    scene2, lights2 = snapshot.load_scene(path)
    np.testing.assert_array_equal(scene2.opaque.positions,
                                  scene.opaque.positions)
    np.testing.assert_array_equal(scene2.opaque.indices, scene.opaque.indices)
    np.testing.assert_array_equal(scene2.material_bank.diffuse_albedo,
                                  scene.material_bank.diffuse_albedo)
    assert lights2.num_dir == 3
    np.testing.assert_array_equal(lights2.strength, lights.strength)


def test_debug_views_render():
    cfg = RenderConfig(width=256, height=144, shadow_map_size=128,
                       pair_capacity=1 << 17, bin_cap=2048,
                       shadow_pair_capacity=1 << 17, shadow_bin_cap=2048,
                       use_pallas=False, ssao_enabled=False,
                       debug_view="shadow_cascade3")
    scene = build_cascade_scene()
    img = Renderer(scene, cfg).render_np(0.0)
    assert img.shape == (144, 256, 4)
    cfg2 = dataclasses.replace(cfg, debug_view="cascades")
    img2 = Renderer(scene, cfg2).render_np(0.0)
    # cascade colorization: colors restricted to the debug palette
    assert not np.allclose(img2, img)
