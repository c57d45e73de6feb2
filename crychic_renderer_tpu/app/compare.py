"""Image comparison tooling (SURVEY.md §4's golden-image layer).

Renders BASELINE configs and reports per-image statistics + optional
diff against stored goldens. The reference has no test images to compare
against (no CI, no goldens shipped); these tools establish OUR golden
baseline and guard regressions between rounds.

Usage:
    python -m crychic_renderer_tpu.app.compare --configs 1 2 3 4 5 \
        --out-dir /tmp/goldens [--small] [--check /path/to/goldens]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def stats(img: np.ndarray) -> dict:
    rgb = img[..., :3]
    return {
        "mean": round(float(rgb.mean()), 6),
        "std": round(float(rgb.std()), 6),
        "p05": round(float(np.quantile(rgb, 0.05)), 6),
        "p95": round(float(np.quantile(rgb, 0.95)), 6),
    }


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    return {
        "max": round(float(diff.max()), 6),
        "mean": round(float(diff.mean()), 6),
        "frac_gt_2pct": round(float((diff > 0.02).mean()), 6),
    }


def parity(configs, small: bool) -> dict:
    """Raster-kernel vs XLA-reference frame parity on the CURRENT backend:
    the compiled kernel on the GPU, the kernel in the Pallas interpreter on
    the CPU (Renderer refuses any other backend). Both paths snap vertices
    identically, so coverage should agree except where f32 edge rounding
    differs; the check bounds visible disagreement per config."""
    import jax

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer

    on_cpu = jax.default_backend() == "cpu"
    report = {"backend": jax.default_backend(),
              "kernel": "interpreted" if on_cpu else "compiled"}
    ok = True
    for c in configs:
        scene, cfg, lights = CONFIGS[c]()
        if small:
            cfg = dataclasses.replace(
                cfg, width=cfg.width // 4, height=cfg.height // 4,
                shadow_map_size=max(cfg.shadow_map_size // 4, 128))
        imgs = {}
        for kernel in (True, False):
            cfgp = dataclasses.replace(cfg, use_pallas=kernel,
                                       pallas_interpret=kernel and on_cpu)
            r = Renderer(scene, cfgp, lights=lights)
            imgs[kernel] = r.render_np(0.0)
        d = compare(imgs[True], imgs[False])
        d["ok"] = d["frac_gt_2pct"] < 0.005
        ok = ok and d["ok"]
        report[c] = d
        print(f"config {c}: {report[c]}", flush=True)
    report["ok"] = ok
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    ap.add_argument("--out-dir", type=str, default="/tmp/crychic_goldens")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--check", type=str, default=None,
                    help="dir of stored goldens (.npy) to diff against")
    ap.add_argument("--parity", action="store_true",
                    help="compare raster-kernel vs XLA-reference frames")
    ap.add_argument("--json-out", type=str, default=None,
                    help="also write the report JSON to this path (exit "
                    "code is nonzero on regression)")
    args = ap.parse_args()

    from . import use_compile_cache

    use_compile_cache()

    if args.parity:
        report = parity(args.configs, args.small)
        print(json.dumps(report))
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(report, f, indent=1)
        raise SystemExit(0 if report["ok"] else 1)

    from ..models.scenes_baseline import CONFIGS
    from .renderer import Renderer, write_png

    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    for c in args.configs:
        scene, cfg, lights = CONFIGS[c]()
        if args.small:
            cfg = dataclasses.replace(
                cfg, width=cfg.width // 4, height=cfg.height // 4,
                shadow_map_size=max(cfg.shadow_map_size // 4, 128))
        r = Renderer(scene, cfg, lights=lights)
        img = r.render_np(0.0)
        write_png(os.path.join(args.out_dir, f"config{c}.png"), img)
        np.save(os.path.join(args.out_dir, f"config{c}.npy"),
                (img * 255).astype(np.uint8))
        report[c] = stats(img)
        if args.check:
            ref = np.load(os.path.join(args.check, f"config{c}.npy"))
            report[c]["diff"] = compare(img, ref.astype(np.float32) / 255.0)
        print(f"config {c}: {report[c]}", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
