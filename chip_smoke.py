"""Smoke test of the renderer on one NVIDIA GPU (four with --multi).

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded frame only

One process drives the card. Phases (each failure is reported and the
script exits non-zero without a result line):

  a. the card's name and power limit (nvidia-smi) and jax.devices(); the
     JAX platform must be "gpu";
  b. the compiled raster kernel against the XLA reference on BASELINE
     config 4 at 1920x1080: the main view (depth, triangle id) and the
     (2048, 8192) four-cascade shadow atlas (depth, triangle id), then
     the whole frame; then the repo's card-only tests (pytest -m gpu);
  c. config 4 at 1920x1080 through Renderer.render: compile, a few
     frames each ending in block_until_ready, a finite image;
  d. config 1 (800x600, forward) the same way.

--multi runs only config 4 at 1920x1080 sharded in 4 row bands
(render_frame_sharded) and as 2 replicas x 2 bands
(render_frames_replicated), each compared with the single-card
render_frame.

Parity bounds: depth |dz| <= 2e-4 wherever both rasterizers pick the same
triangle; the main view's triangle id differs on <= 0.5% of pixels, and
the atlas depth moves by more than 2e-4 on <= 0.5% of texels; <= 0.5% of
image pixels move by more than 2%. Sharded frames: < 0.1% of pixels move by
more than 2%. Everything is float32 (jax_default_matmul_precision is
"float32", so no matrix product runs in TF32).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
import traceback

import numpy as np

DZ_BOUND = 2e-4
TID_BOUND = 0.005
IMG_BOUND = 0.005
SHARD_BOUND = 1e-3
FRAMES = 5


def card_line() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _frac_moved(a, b, thresh=0.02) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1)
                  > thresh).mean())


def _compare_raster(name, dk, tk, dx, tx, ids_used: bool) -> dict:
    """Kernel (dk, tk) vs reference (dx, tx) depth and triangle ids. Where
    the frame uses the ids (the main view), at most TID_BOUND of pixels
    may pick another triangle; where it uses only depth (the shadow
    atlas), at most TID_BOUND of pixels may move depth by more than
    DZ_BOUND (an id flip between fragments of equal depth, e.g. at the
    far plane, changes nothing there)."""
    dk, tk, dx, tx = map(np.asarray, (dk, tk, dx, tx))
    same = (tk == tx) & (tk >= 0)
    dz = float(np.abs(dk - dx)[same].max()) if same.any() else 0.0
    rep = {"dz_max_same_tri": dz, "tid_mismatch": float((tk != tx).mean()),
           "depth_moved": float((np.abs(dk - dx) > DZ_BOUND).mean()),
           "covered": float((tk >= 0).mean()), "shape": list(dk.shape)}
    flips = rep["tid_mismatch"] if ids_used else rep["depth_moved"]
    rep["ok"] = bool(dz <= DZ_BOUND and flips <= TID_BOUND
                     and rep["covered"] > 0)
    print(f"  {name}: {json.dumps(rep)}", flush=True)
    return rep


def raster_parity(scene, cfg, lights) -> bool:
    """Phase b: the compiled kernel vs the XLA reference at config 4's
    real widths, raster by raster and for the whole frame."""
    import jax
    import jax.numpy as jnp

    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.ops import rasterizer as rz
    from crychic_renderer_tpu.ops import raster_pallas as rp
    from crychic_renderer_tpu.ops import shading
    from crychic_renderer_tpu.passes import frame as fr

    rk = Renderer(scene, dataclasses.replace(cfg, use_pallas=True),
                  lights=lights)
    rx = Renderer(scene, dataclasses.replace(cfg, use_pallas=False),
                  lights=lights)
    consts = rk.frame_constants(0.0)
    interp = rk.cfg.pallas_interpret  # CPU rehearsals only
    W, H, S = rk.cfg.width, rk.cfg.height, rk.cfg.shadow_map_size
    C = rk.cfg.num_cascades
    ok = True

    # main view: same triangles through both rasterizers
    tris, _ = jax.jit(functools.partial(fr.main_view_tris, cfg=rk.cfg))(
        rk.device_scene, consts)
    dk, tk = jax.jit(lambda t: rp.rasterize_pallas(
        t, W, H, rk.cfg.pair_capacity, interpret=interp))(tris)
    dx, tx = jax.jit(lambda t: rz.rasterize_binned(
        t, rz.bin_triangles(t, W, H, rx.cfg.pair_capacity), W, H,
        rx.cfg.bin_cap))(tris)
    ok &= _compare_raster(f"main view {W}x{H}", dk, tk, dx, tx,
                          ids_used=True)["ok"]

    # shadow atlas: the kernel's one (S, C*S) launch vs the reference's
    # per-cascade renders (the XLA frame's shadow path), ids included
    atris, xr = jax.jit(lambda s, c: fr.shadow_atlas_tris(
        s, c.shadow_visibility, c.cascade_view_projs, rk.cfg))(
            rk.device_scene, consts)
    ak, atk = jax.jit(lambda t, x: rp.rasterize_pallas(
        t, C * S, S, rk.cfg.shadow_pair_capacity, xrange=x,
        interpret=interp))(atris, xr)
    n_tri = atris.xy.shape[0] // C

    @jax.jit
    def xla_cascades(scene, consts):
        tw = fr.shadow_tri_world(scene.shadow, consts.shadow_visibility)
        outs = []
        for c in range(C):
            t = fr._shadow_bias(rz.setup_tri_verts(
                shading.rowmat(tw, consts.cascade_view_projs[c]), None, S,
                S))
            d, i = rz.rasterize_binned(
                t, rz.bin_triangles(t, S, S, rx.cfg.shadow_pair_capacity),
                S, S, rx.cfg.shadow_bin_cap)
            outs.append((d, jnp.where(i >= 0, i + c * n_tri, -1)))
        return (jnp.concatenate([o[0] for o in outs], 1),
                jnp.concatenate([o[1] for o in outs], 1))

    ax, atx = xla_cascades(rk.device_scene, consts)
    ok &= _compare_raster(f"shadow atlas {S}x{C * S}", ak, atk, ax, atx,
                          ids_used=False)["ok"]

    img_k = rk.render(0.0)
    img_x = rx.render(0.0)
    frac = _frac_moved(img_k, img_x)
    fin = bool(np.isfinite(np.asarray(img_k)).all())
    print(f"  whole frame: {frac:.6f} of pixels moved > 2% "
          f"(bound {IMG_BOUND}), finite {fin}", flush=True)
    return bool(ok and frac <= IMG_BOUND and fin)


def gpu_tests() -> bool:
    """Phase b (cont.): the repo's card-only tests, in this process. Only
    the files that hold ``gpu``-marked tests are collected."""
    import pathlib

    import pytest

    tests = pathlib.Path(__file__).resolve().parent / "tests"
    files = [str(f) for f in sorted(tests.glob("test_*.py"))
             if "pytest.mark.gpu" in f.read_text()]
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", *files])
    print(f"  pytest -m gpu {[pathlib.Path(f).name for f in files]}: exit "
          f"{int(rc)}", flush=True)
    return bool(files) and int(rc) == 0


def render_config(n: int, card: str) -> bool:
    """Phases c/d: BASELINE config n through Renderer.render."""
    from crychic_renderer_tpu.app.renderer import (Renderer,
                                                   missing_texture_slots)
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS

    scene, cfg, lights = CONFIGS[n]()
    t0 = time.perf_counter()
    r = Renderer(scene, cfg, lights=lights)
    img = r.render(0.0).block_until_ready()
    setup_s = time.perf_counter() - t0
    ts = []
    for i in range(FRAMES):
        t = time.perf_counter()
        img = r.render((i + 1) / 60.0).block_until_ready()
        ts.append((time.perf_counter() - t) * 1e3)
    img = np.asarray(img)
    fin = bool(np.isfinite(img).all())
    shape_ok = img.shape == (cfg.height, cfg.width, 4)
    missing = missing_texture_slots(scene.texture_names)
    raster = "kernel" if r.cfg.use_pallas else "xla"
    if r.cfg.pallas_interpret:
        raster += " (interpreted)"
    print(f"  config {n} {cfg.width}x{cfg.height}: ms/frame median "
          f"{float(np.median(ts))} min {min(ts)} over {FRAMES} frames "
          f"[{card}]; setup+compile {setup_s:.1f} s; rasterizer {raster}; "
          f"{len(missing)} texture slots fell back to white {missing}; "
          f"finite {fin}, shape {img.shape}", flush=True)
    return fin and shape_ok and raster == "kernel"


def multi(card: str) -> bool:
    """--multi: config 4 at 1080p sharded over 4 cards, and 2 replicas x
    2 bands, each against the single-card frame."""
    import jax

    from crychic_renderer_tpu.app.renderer import Renderer
    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS
    from crychic_renderer_tpu.parallel import sharded
    from crychic_renderer_tpu.passes import frame as fr

    scene, cfg, lights = CONFIGS[4]()
    r = Renderer(scene, cfg, lights=lights)
    c0 = r.frame_constants(0.0)
    r.camera.walk(1.0)
    r.camera.rotate_y(0.05)
    c1 = r.frame_constants(0.5)
    single = jax.jit(functools.partial(fr.render_frame, cfg=r.cfg))
    ref = [np.asarray(single(r.device_scene, c)) for c in (c0, c1)]
    ok = True

    cfg4 = sharded.autosize_band_capacities(r.device_scene, c0, r.cfg, 4)
    sharded.check_band_capacity(r.device_scene, c0, cfg4, 4)
    fn = jax.jit(functools.partial(sharded.render_frame_sharded, cfg=cfg4,
                                   mesh=sharded.make_mesh(4)))
    img = fn(r.device_scene, c0).block_until_ready()
    ts = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        img = fn(r.device_scene, c0).block_until_ready()
        ts.append((time.perf_counter() - t) * 1e3)
    frac = _frac_moved(img, ref[0])
    print(f"  4 bands: {frac:.6f} of pixels moved > 2% (bound "
          f"{SHARD_BOUND}); ms/frame median {float(np.median(ts))} "
          f"[4 x {card}]", flush=True)
    ok &= frac < SHARD_BOUND

    cfg2 = sharded.autosize_band_capacities(r.device_scene, c0, r.cfg, 2)
    for c in (c0, c1):
        sharded.check_band_capacity(r.device_scene, c, cfg2, 2)
    fn2 = jax.jit(functools.partial(sharded.render_frames_replicated,
                                    cfg=cfg2, mesh=sharded.make_mesh2(2, 2)))
    args = (sharded.stack_frames([r.device_scene, r.device_scene]),
            sharded.stack_frames([c0, c1]))
    imgs = fn2(*args).block_until_ready()
    ts = []
    for _ in range(FRAMES):
        t = time.perf_counter()
        imgs = fn2(*args).block_until_ready()
        ts.append((time.perf_counter() - t) * 1e3)
    imgs = np.asarray(imgs)
    for i in range(2):
        frac = _frac_moved(imgs[i], ref[i])
        print(f"  2x2 replica {i}: {frac:.6f} of pixels moved > 2% "
              f"(bound {SHARD_BOUND})", flush=True)
        ok &= frac < SHARD_BOUND
    print(f"  2x2: ms per 2 frames median {float(np.median(ts))} "
          f"[4 x {card}]", flush=True)
    return bool(ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the sharded config-4 frame only")
    args = ap.parse_args(argv)

    import jax

    from crychic_renderer_tpu.app import use_compile_cache

    use_compile_cache()
    devs = jax.devices()
    print(f"jax.devices(): {devs}", flush=True)
    if devs[0].platform != "gpu":
        print(f"FAIL: JAX platform is {devs[0].platform!r}, not 'gpu'",
              flush=True)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    need = 4 if args.multi else 1
    if len(devs) < need:
        print(f"FAIL: {need} devices needed, {len(devs)} found", flush=True)
        return 2

    from crychic_renderer_tpu.models.scenes_baseline import CONFIGS

    if args.multi:
        phases = [("multi: config 4 sharded", lambda: multi(card))]
    else:
        phases = [
            ("b: kernel vs XLA reference, config 4",
             lambda: raster_parity(*CONFIGS[4]())),
            ("b: card-only tests", gpu_tests),
            ("c: config 4 render", lambda: render_config(4, card)),
            ("d: config 1 render", lambda: render_config(1, card)),
        ]
    failed = []
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc()
            ok = False
        print(f"phase {name}: {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not ok:
            failed.append(name)
    if failed:
        print(f"FAIL: {failed}", flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
