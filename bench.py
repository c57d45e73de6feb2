"""Headline benchmark: BASELINE config 4 (the cascade scene: 1080p,
deferred G-buffer, 4 cascades of 2048^2 in one atlas, PCF, half-res SSAO,
GGX PBR, sky) through Renderer.render on the default JAX device.

Prints ONE JSON line:
    {"metric": ..., "value": ms_per_frame, "unit": "ms/frame",
     "vs_baseline": baseline_ms / value, "device": {...},
     "rasterizer": "kernel" | "xla"}

vs_baseline > 1 means faster than the 16 ms/frame (60 Hz) target. Any
failure exits non-zero and prints no result. The per-cell benchmark is
separate work (ROADMAP S1).
"""
from __future__ import annotations

import json
import time

BASELINE_MS = 16.0
FRAMES = 20


def main():
    import jax

    from crychic_renderer_tpu.app import use_compile_cache
    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.models.scenes_baseline import (
        config4_shadow_pipeline)

    use_compile_cache()
    scene, cfg, lights = config4_shadow_pipeline()
    r = Renderer(scene, cfg, lights=lights)
    r.render(0.0).block_until_ready()  # compile

    # frames back to back with each one finished before the next is timed
    # as done: ms/frame is the mean wall time of a synchronous frame
    t0 = time.perf_counter()
    for i in range(FRAMES):
        r.render(i / 60.0).block_until_ready()
    ms = 1000.0 * (time.perf_counter() - t0) / FRAMES

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "ms/frame 1080p config 4 cascade scene "
                  "deferred+shadows+SSAO+PBR",
        "value": round(ms, 3),
        "unit": "ms/frame",
        "vs_baseline": round(BASELINE_MS / ms, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "rasterizer": "kernel" if r.cfg.use_pallas else "xla",
    }))


if __name__ == "__main__":
    main()
