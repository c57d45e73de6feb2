"""Fuzz parity: random camera poses through BOTH rasterizer back ends
and through the sharded band pipeline.

The committed goldens pin five fixed viewpoints; this fuzzes the
viewpoint axis — random walk/strafe/pitch/yaw sequences must render
identically through the raster kernel (interpret mode) and the pure-XLA
rasterizer. Both paths snap vertices identically, so any
visible disagreement beyond fp edge rounding is a binning/clipping/
capacity bug that the fixed-camera goldens cannot see (e.g. a
tile-boundary case that only a particular frustum hits).

Coverage:
- config 4 (1/8): cascades + SSAO + deferred, the original axis;
- config 2 (1/8): forward path, skull mesh, 3-light non-PBR;
- config 5 (1/8): anisotropy, animated material slots (t=0.1), skull +
  car meshes, alpha-tested fence — the full-feature surface;
- sharded: random poses through the 4-device band pipeline vs the
  single-chip frame (a pose-dependent band-seam or per-band-capacity
  bug cannot hide behind the fixed-camera sharded tests).

Camera perturbations stay within the capacity autosizing's 1.5x headroom
(checked explicitly via Renderer.check_capacity, so a pose that would
overflow FAILS loudly rather than silently truncating one path).
"""
import dataclasses
import functools

import numpy as np
import pytest

from crychic_renderer_tpu.models.scenes_baseline import CONFIGS


def _apply_pose(cam, rng):
    """A modest random pose: the viewer's own key semantics, bounded so
    the pair load stays inside the sized capacities."""
    cam.walk(float(rng.uniform(-3.0, 3.0)))
    cam.strafe(float(rng.uniform(-3.0, 3.0)))
    cam.rotate_y(float(rng.uniform(-0.4, 0.4)))
    cam.pitch(float(rng.uniform(-0.15, 0.15)))
    cam.update_view_matrix()


def _small_cfg(cfg):
    return dataclasses.replace(
        cfg, width=cfg.width // 8, height=cfg.height // 8,
        shadow_map_size=max(cfg.shadow_map_size // 8, 128))


@pytest.fixture(scope="module", params=[2, 4, 5])
def renderer_pair(request):
    from crychic_renderer_tpu.app.renderer import Renderer

    scene, cfg, lights = CONFIGS[request.param]()
    cfg = _small_cfg(cfg)
    r_xla = Renderer(scene, dataclasses.replace(cfg, use_pallas=False),
                     lights=lights)
    # the kernel in interpret mode (its capacities autosize at its tiles)
    r_pl = Renderer(scene, dataclasses.replace(cfg, use_pallas=True,
                                               pallas_interpret=True),
                    lights=lights)
    assert r_pl.cfg.use_pallas and not r_xla.cfg.use_pallas
    return request.param, r_xla, r_pl


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_pose_pallas_xla_parity(renderer_pair, seed):
    config, r_xla, r_pl = renderer_pair
    _apply_pose(r_xla.camera, np.random.default_rng(seed))
    _apply_pose(r_pl.camera, np.random.default_rng(seed))
    # the pose must be inside both paths' sized capacities (else the
    # comparison could "pass" on identically-truncated geometry)
    t = 0.1 if config == 5 else 0.0  # t=0.1: animated slots have cycled
    r_xla.ensure_capacity(t)  # grow-and-recompile if the pose outruns
    r_pl.ensure_capacity(t)   # the 1.25x tile headroom
    a = r_xla.render_np(t)
    b = r_pl.render_np(t)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    frac = (diff > 0.02).mean()
    assert frac < 0.005, (
        f"config {config} seed {seed}: {frac:.4%} of pixels disagree >2% "
        f"between the kernel and XLA rasterizers (max {diff.max():.4f})")


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2])
def test_random_pose_sharded_parity(seed):
    """Random poses through the 4-device band pipeline: band ownership,
    per-band capacities and halo rows are all pose-dependent, so a seam
    bug that only a particular horizon position hits is invisible to the
    fixed-camera sharded tests."""
    import jax

    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.parallel import sharded
    from crychic_renderer_tpu.passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    cfg = dataclasses.replace(_small_cfg(cfg), use_pallas=False)
    r = Renderer(scene, cfg, lights=lights)
    _apply_pose(r.camera, np.random.default_rng(100 + seed))
    r.ensure_capacity(0.0)
    cfg = r.cfg  # autosized capacities
    consts = r.frame_constants(0.0)
    single = np.asarray(jax.jit(functools.partial(
        fr.render_frame, cfg=cfg))(r.device_scene, consts))
    mesh = sharded.make_mesh(4)
    # the band capacity check mirrors the production path: a pose whose
    # band pair load overflows must fail loudly here, not truncate
    sharded.check_band_capacity(r.device_scene, consts, cfg, 4)
    multi = np.asarray(jax.jit(functools.partial(
        sharded.render_frame_sharded, cfg=cfg, mesh=mesh))(
            r.device_scene, consts))
    assert multi.shape == single.shape
    diff = np.abs(multi - single).max(axis=-1)
    visible = diff > 0.02
    assert visible.mean() < 1e-3, (
        f"seed {seed}: sharded band frame diverges from single-chip "
        f"({visible.mean():.4%} pixels >2%, max {diff.max():.4f})")
