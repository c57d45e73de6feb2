"""CLI frame runner.

Usage::

    python -m crychic_renderer_tpu.app.run --config 4 --frames 3 \
        --out /tmp/frame.png [--small] [--stats]

Renders N frames of a BASELINE config and writes the last one as PNG.
Prints per-frame ms + FPS — the reference's title-bar stats
(/root/reference/Common/d3dApp.cpp:598-628 CalculateFrameStats).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", type=str, default="/tmp/crychic_frame.png")
    ap.add_argument("--small", action="store_true",
                    help="render at 1/4 resolution (fast CPU iteration)")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--backend", type=str, default=None,
                    help="force JAX_PLATFORMS (e.g. cpu)")
    ap.add_argument("--orbit", action="store_true",
                    help="orbit the camera across frames (demo/stability)")
    ap.add_argument("--fast", action="store_true",
                    help="performance preset: half-res shadow factor")
    args = ap.parse_args()

    if args.backend:
        import os

        os.environ["JAX_PLATFORMS"] = args.backend

    from ..models.scenes_baseline import CONFIGS
    from . import use_compile_cache
    from .renderer import Renderer, write_png

    use_compile_cache()
    scene, cfg, lights = CONFIGS[args.config]()
    if args.fast:
        # documented performance preset (RenderConfig.fast_preset)
        cfg = cfg.fast_preset()
    if args.small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 4, height=cfg.height // 4,
            shadow_map_size=max(cfg.shadow_map_size // 4, 128),
            pair_capacity=cfg.pair_capacity // 2,
            shadow_pair_capacity=cfg.shadow_pair_capacity // 2)

    print(f"config {args.config}: {cfg.width}x{cfg.height}, "
          f"deferred={cfg.deferred} shadows={cfg.shadows_enabled} "
          f"ssao={cfg.ssao_enabled} tris={scene.opaque.num_triangles}")
    t0 = time.time()
    r = Renderer(scene, cfg, lights=lights)
    print(f"scene upload: {time.time() - t0:.1f}s; rasterizer: "
          f"{'kernel' if r.cfg.use_pallas else 'XLA'}"
          f"{' (interpreted)' if r.cfg.pallas_interpret else ''}")

    t0 = time.time()
    frame = r.render(0.0).block_until_ready()
    print(f"first frame (incl. compile): {time.time() - t0:.1f}s")

    # ms/frame: the frame on the device, ending in block_until_ready; the
    # copy of the image to the host is not part of it
    times = []
    for i in range(args.frames):
        if args.orbit:
            r.camera.rotate_y(0.05)
        t0 = time.perf_counter()
        frame = r.render(i / 60.0).block_until_ready()
        times.append(time.perf_counter() - t0)
    ms = 1000.0 * float(np.median(times))
    print(f"ms/frame: {ms:.2f}   fps: {1000.0 / ms:.1f}")
    img = np.clip(np.asarray(frame), 0.0, 1.0)

    write_png(args.out, img)
    print(f"wrote {args.out}")
    if args.stats:
        req = r.check_capacity(0.0)  # raises on overflow
        print(json.dumps({"ms_per_frame": ms, "fps": 1000.0 / ms,
                          "config": args.config,
                          "capacity": {k: int(v) for k, v in req.items()},
                          "pair_capacity": r.cfg.pair_capacity,
                          "shadow_pair_capacity":
                              r.cfg.shadow_pair_capacity}))


if __name__ == "__main__":
    main()
