"""Interactive viewer: the reference's live app loop, terminal-native.

Replicates the input semantics of CRYCHIC::OnKeyboardInput
(/root/reference/CRYCHIC.cpp:467-483: W/S walk +-10 units/s, A/D strafe)
and OnMouseMove (:497-513: 0.25 deg per count pitch / rotateY) driven from
the keyboard, inside the D3DApp::Run message-pump frame loop
(/root/reference/Common/d3dApp.cpp:72-101) with the 1-second caption stats
(d3dApp.cpp:598-628).

There is no window system in this environment, so the swapchain is the
terminal: every frame is (optionally) shown as a truecolor half-block
image via ANSI escapes, and `p` dumps the current frame to PNG.

Keys: w/a/s/d move, i/k pitch, j/l turn, space pause (GameTimer
Stop/Start — animated textures freeze, like the reference's WM_ACTIVATE
handling, d3dApp.cpp:222-238), p screenshot, q quit.

Usage::

    python -m crychic_renderer_tpu.app.viewer --config 4 --small
    python -m crychic_renderer_tpu.app.viewer --config 1 --script wwjjp \
        --max-frames 8 --no-draw     # scripted/headless (tests, CI)
"""
from __future__ import annotations

import argparse
import dataclasses
import select
import sys

import numpy as np

WALK_SPEED = 10.0        # units/s (CRYCHIC.cpp:470-482)
TURN_STEP = 32.0 * 0.25  # degrees per key tick ~ 32 mouse counts (:507-512)


class _RawKeys:
    """Non-blocking single-key reads from a tty; no-op elsewhere."""

    def __init__(self, enabled: bool):
        self.enabled = enabled and sys.stdin.isatty()
        self._old = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._old = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              self._old)

    def poll(self) -> str:
        if not self.enabled:
            return ""
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return "".join(keys)


def apply_keys(camera, keys: str, dt: float) -> bool:
    """Drive the camera exactly like the reference's input handlers.
    Returns False when `q` was pressed."""
    for k in keys:
        if k == "w":
            camera.walk(WALK_SPEED * dt)
        elif k == "s":
            camera.walk(-WALK_SPEED * dt)
        elif k == "a":
            camera.strafe(-WALK_SPEED * dt)
        elif k == "d":
            camera.strafe(WALK_SPEED * dt)
        elif k == "i":
            camera.pitch(-np.deg2rad(TURN_STEP))
        elif k == "k":
            camera.pitch(np.deg2rad(TURN_STEP))
        elif k == "j":
            camera.rotate_y(-np.deg2rad(TURN_STEP))
        elif k == "l":
            camera.rotate_y(np.deg2rad(TURN_STEP))
        elif k == "q":
            return False
    camera.update_view_matrix()
    return True


def display_dims(height: int, width: int, cols: int = 120):
    """Terminal display raster: 2 image rows per text row."""
    cols = min(cols, width)
    rows = max(2, int(cols * height / width)) & ~1
    return rows, cols


def ansi_frame(img: np.ndarray, cols: int = 120) -> str:
    """Truecolor half-block rendering of an image (float [0,1] full-res or
    uint8 already display-sized)."""
    if img.dtype == np.uint8:
        rgb = img[..., :3].astype(int)
    else:
        h, w = img.shape[:2]
        rows, cols = display_dims(h, w, cols)
        ys = (np.linspace(0, h - 1, rows)).astype(int)
        xs = (np.linspace(0, w - 1, cols)).astype(int)
        rgb = (np.clip(img[ys][:, xs, :3], 0, 1) * 255).astype(int)
    rows = rgb.shape[0]
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(rgb.shape[1]):
            tr, tg, tb = rgb[r, c]
            br, bg, bb = rgb[r + 1, c]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--small", action="store_true")
    # interactivity defaults: the LIVE viewer uses the documented fast
    # preset at 720p; renders, goldens, bench and `--parity/--res 1080p`
    # keep full parity.
    ap.add_argument("--fast", dest="fast", action="store_true",
                    default=True,
                    help="performance preset: half-res PCF factor, "
                    "quarter-res SSAO, 2-probe aniso (viewer default)")
    ap.add_argument("--parity", dest="fast", action="store_false",
                    help="disable the fast preset (bench-parity image)")
    ap.add_argument("--res", choices=["native", "1080p", "720p"],
                    default="720p",
                    help="viewer resolution (720p default for "
                    "interactivity; 'native' keeps the config's size)")
    ap.add_argument("--script", type=str, default=None,
                    help="scripted key sequence (one key per frame; "
                    "disables tty input)")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop after N frames (0 = until q)")
    ap.add_argument("--no-draw", action="store_true",
                    help="skip terminal drawing (headless)")
    ap.add_argument("--cols", type=int, default=120)
    ap.add_argument("--out", type=str, default="/tmp/viewer_frame.png")
    ap.add_argument("--backend", type=str, default=None)
    args = ap.parse_args(argv)

    if args.backend:
        import os

        os.environ["JAX_PLATFORMS"] = args.backend

    from ..models.scenes_baseline import CONFIGS
    from ..utils.gametimer import GameTimer
    from . import use_compile_cache
    from .renderer import Renderer, write_png
    from .stats import FrameStats

    use_compile_cache()
    scene, cfg, lights = CONFIGS[args.config]()
    if args.fast:
        # documented performance preset
        cfg = cfg.fast_preset()
    if args.res != "native":
        h = 1080 if args.res == "1080p" else 720
        w = h * 16 // 9
        if (cfg.width, cfg.height) != (w, h):
            cfg = dataclasses.replace(cfg, width=w, height=h)
    if args.small:
        cfg = dataclasses.replace(
            cfg, width=cfg.width // 4, height=cfg.height // 4,
            shadow_map_size=max(cfg.shadow_map_size // 4, 128),
            pair_capacity=cfg.pair_capacity // 2,
            shadow_pair_capacity=cfg.shadow_pair_capacity // 2)

    r = Renderer(scene, cfg, lights=lights)
    stats = FrameStats()
    stats.total_instances = scene.opaque.num_instances

    # Frames in flight (gNumFrameResources=3, CRYCHIC.h:20 + the fence
    # wait, CRYCHIC.cpp:135-146): dispatch frame i, fetch/display frame
    # i-(DEPTH-1). The fetch is a tiny display-sized uint8 transfer
    # (viewer_step_fn) instead of the full float32 frame, so interactive
    # throughput tracks the render rate, not a device-to-host copy of
    # every frame. Each fetch also surfaces the frame's
    # exact pair counts: an over-capacity camera walk raises (2 frames
    # late) instead of silently dropping triangles.
    DEPTH = 3
    from collections import deque

    disp_rows, disp_cols = display_dims(r.cfg.height, r.cfg.width, args.cols)
    step = r.viewer_step_fn(disp_rows, disp_cols)

    def fetch_and_show(entry):
        disp, mp, sp = entry
        mp, sp = int(mp), int(sp)
        if mp > r.cfg.pair_capacity:
            raise RuntimeError(
                f"main raster overflow: frame expanded to {mp} pairs > "
                f"pair_capacity {r.cfg.pair_capacity} (camera moved past "
                "the auto-sized headroom; rebuild the Renderer)")
        if sp > r.cfg.shadow_pair_capacity:
            raise RuntimeError(
                f"shadow raster overflow: {sp} pairs > "
                f"shadow_pair_capacity {r.cfg.shadow_pair_capacity}")
        if not args.no_draw:
            sys.stdout.write("\x1b[H\x1b[2J"
                             + ansi_frame(np.asarray(disp)) + "\n")

    scripted = list(args.script) if args.script is not None else None
    timer = GameTimer()
    timer.reset()
    frames = 0
    running = True
    paused = False
    pending = deque()
    with _RawKeys(enabled=scripted is None) as raw:
        while running:
            timer.tick()
            dt = max(timer.delta_time(), 0.0)
            keys = scripted.pop(0) if scripted else raw.poll()
            if " " in keys:
                paused = not paused
                (timer.stop if paused else timer.start)()
            t = timer.total_time()
            if "p" in keys:
                write_png(args.out, r.render_np(t))
                print(f"\nwrote {args.out}", flush=True)
            running = apply_keys(r.camera, keys, dt)

            r._animate_materials(t)
            consts = r.frame_constants(t)
            pending.append(step(r.device_scene, consts))
            frames += 1
            stats.visible_instances = int(
                np.asarray(consts.opaque_visibility).sum())
            if len(pending) >= DEPTH:
                fetch_and_show(pending.popleft())
            if stats.tick() or (scripted is not None):
                preset = "fast" if args.fast else "parity"
                print(f"{stats.caption()}   [{preset} "
                      f"{r.cfg.width}x{r.cfg.height}]", flush=True)
            if args.max_frames and frames >= args.max_frames:
                running = False
            if scripted is not None and not scripted:
                running = False
        while pending:  # drain the pipeline (shows the last frames)
            fetch_and_show(pending.popleft())
    return frames


if __name__ == "__main__":
    main()
