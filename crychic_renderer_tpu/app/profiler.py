"""Per-pass profiling.

The reference's only profiling hook is a 1-second FPS average in the
window caption (d3dApp.cpp:598-628). Here each pass can be timed on the
device: every stage is jitted separately and timed on the host clock
around calls that end in ``block_until_ready``.

Usage:
    from crychic_renderer_tpu.app.profiler import profile_frame
    report = profile_frame(renderer)   # dict pass -> ms
"""
from __future__ import annotations

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
from ..ops import rasterizer as rz
from ..ops import raster_pallas as rp
from ..passes import frame as fr


def _time(fn, *args, reps: int = 5, **kwargs) -> float:
    """Mean ms per call after one warm-up (compile) call; every call ends
    in block_until_ready."""
    jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / reps * 1000.0


def profile_frame(renderer, total_time: float = 0.0, reps: int = 5) -> dict:
    """Time each pass of the deferred pipeline separately. Returns
    {pass_name: ms}. Stage boundaries force materialization, so the sum
    overstates the fused frame slightly (no cross-pass fusion)."""
    scene = renderer.device_scene
    cfg = renderer.cfg
    consts = renderer.frame_constants(total_time)
    H, W = cfg.height, cfg.width
    report = {}

    va = jax.jit(lambda s, c: fr.tri_attrs(
        s.opaque, c.opaque_visibility, c.view_proj, s.mat_transform))
    report["tri_attrs"] = _time(va, scene, consts, reps=reps)
    tri_attr0 = va(scene, consts)

    def setup_fn(ta):
        from ..ops import clipping

        ta, tv = clipping.clip_near(ta, jnp.ones(ta.shape[0], bool))
        return ta, rz.setup_tri_verts(ta[..., :4], tv, W, H)

    setup = jax.jit(setup_fn)
    report["tri_setup"] = _time(setup, tri_attr0, reps=reps)
    tri_attr, tris = setup(tri_attr0)

    if fr.uses_kernel(cfg):
        raster = jax.jit(lambda tr: rp.rasterize_pallas(
            tr, W, H, cfg.pair_capacity, interpret=cfg.pallas_interpret))
    else:
        raster = jax.jit(lambda tr: rz.rasterize_binned(
            tr, rz.bin_triangles(tr, W, H, cfg.pair_capacity), W, H,
            cfg.bin_cap))
    report["raster_main"] = _time(raster, tris, reps=reps)
    depth, tid = raster(tris)

    resolve = jax.jit(functools.partial(fr.resolve_gbuffer, cfg=cfg))
    report["resolve_gbuffer"] = _time(
        resolve, scene, consts, tris=tris, depth=depth, tid=tid,
        tri_attr=tri_attr, reps=reps)
    g = resolve(scene, consts, tris=tris, depth=depth, tid=tid,
                tri_attr=tri_attr)

    if cfg.shadows_enabled:
        shadow = jax.jit(functools.partial(fr.render_shadow_maps, cfg=cfg))
        report["shadow_maps_x4"] = _time(shadow, scene, consts, reps=reps)
        shadow_maps = shadow(scene, consts)
    else:
        shadow_maps = jnp.ones((cfg.num_cascades, 2, 2), jnp.float32)

    if cfg.ssao_enabled:
        ssao = jax.jit(functools.partial(fr.ssao_pass, cfg=cfg))
        report["ssao"] = _time(ssao, scene, consts, normal_v=g["normal_v"],
                               depth=depth, reps=reps)
        access = ssao(scene, consts, normal_v=g["normal_v"], depth=depth)
        up = jax.jit(lambda a: fr._upsample_bilinear(a, H, W))
        ambient_access = up(access)
    else:
        ambient_access = jnp.ones((H, W), jnp.float32)

    light = jax.jit(functools.partial(fr.lighting_pass, cfg=cfg))
    report["lighting"] = _time(light, scene, consts, g=g,
                               shadow_maps=shadow_maps,
                               ambient_access=ambient_access, depth=depth,
                               reps=reps)

    full = jax.jit(functools.partial(fr.render_frame, cfg=cfg))
    report["TOTAL_fused"] = _time(full, scene, consts, reps=reps)
    return report


def main():
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from ..models.scenes_baseline import CONFIGS
    from . import use_compile_cache
    from .renderer import Renderer

    use_compile_cache()
    scene, cfg, lights = CONFIGS[args.config]()
    if args.small:
        cfg = dataclasses.replace(cfg, width=cfg.width // 4,
                                  height=cfg.height // 4,
                                  shadow_map_size=cfg.shadow_map_size // 4)
    r = Renderer(scene, cfg, lights=lights)
    report = profile_frame(r, reps=args.reps)
    for k, v in report.items():
        print(f"{k:20s} {v:10.2f} ms")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
