"""Host-side renderer orchestration.

The functional replacement of the reference's app shell + frame loop
(/root/reference/Common/d3dApp.cpp Run/Initialize, CRYCHIC::Update/Draw):
builds the device scene once, computes per-frame constants (camera
matrices, cascade fits, culling masks) on host, and calls the jitted frame
function. CPU/GPU pipelining via 3 FrameResources (CRYCHIC.cpp:135-146)
maps to XLA async dispatch — the host runs ahead until it blocks on
fetching a frame, exactly the fence-wait pattern, with no explicit fences.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.camera import Camera, BoundingFrustum
from ..models import cascades as casc
from ..models.materials import build_reference_lights
from ..models.scene import Scene
from ..ops import raster_pallas as rp, sampling, ssao as ssao_ops
from ..passes import frame as fr

DEFAULT_ASSET_DIR = "/root/reference/Textures"

# Texture slot names -> DDS file stems (LoadTextures, CRYCHIC.cpp:939-974;
# slots 7-9 are unused in the reference's 10-slot table).
_TEXTURE_FILES = {
    "bricks2": "bricks2.dds",
    "bricks2_nmap": "bricks2_nmap.dds",
    "tile": "tile.dds",
    "tile_nmap": "tile_nmap.dds",
    "white1x1": "white1x1.dds",
    "default_nmap": "default_nmap.dds",
    "WoodCrate01": "WoodCrate01.dds",
    "WoodCrate02": "WoodCrate02.dds",
    "bricks": "bricks.dds",
    "bricks_nmap": "bricks_nmap.dds",
    "stone": "stone.dds",
    "checkboard": "checkboard.dds",
    "ice": "ice.dds",
    "grass": "grass.dds",
    "WireFence": "WireFence.dds",
    "water1": "water1.dds",
}


# animated texture slots: name -> (frames dir, subsample step, fps)
_ANIM_SLOTS = {
    "bolt_anim": ("BoltAnim", 4, 30.0),
    "fire_anim": ("FireAnim", 8, 30.0),
}


def load_texture_chains(names, asset_dir=DEFAULT_ASSET_DIR):
    """Load the named texture slots as mip chains (mips generated for
    mipless textures, like D3D12 would sample the base level repeatedly —
    we improve on that with generated mips).

    Returns (chains, anim_frames): chains[slot] = [(H, W, 4) u8 mips];
    anim_frames[slot] = ([per-frame chains], fps) for animated slots
    (BoltAnim/FireAnim BMP sequences).
    """
    from ..io import dds

    white = [np.full((1, 1, 4), 255, np.uint8)]
    chains = []
    anim_frames = {}
    for slot, name in enumerate(names):
        if name == "sky_cube":
            chains.append(white)  # cube slots don't live in the 2D pool
            continue
        if name in _ANIM_SLOTS:
            subdir, step, fps = _ANIM_SLOTS[name]
            d = os.path.join(asset_dir, subdir)
            files = sorted(os.listdir(d))[::step] if os.path.isdir(d) else []
            frames = [dds.generate_mips(dds.load_bmp(os.path.join(d, f)))
                      for f in files]
            if not frames:
                frames = [white]
            chains.append(frames[0])  # slot shows frame 0
            anim_frames[slot] = (frames, fps)
            continue
        fn = _TEXTURE_FILES.get(name)
        if fn is None or not os.path.exists(os.path.join(asset_dir, fn)):
            chains.append(white)
            continue
        tex = dds.load_dds(os.path.join(asset_dir, fn))
        mips = tex.mips
        if len(mips) == 1 and mips[0].shape[0] > 1:
            mips = dds.generate_mips(mips[0])
        chains.append(mips)
    return chains, anim_frames


def missing_texture_slots(names, asset_dir=DEFAULT_ASSET_DIR):
    """The named texture slots whose files are absent from ``asset_dir``:
    load_texture_chains gives each of them a white 1x1 texture."""
    missing = []
    for name in names:
        if name == "sky_cube":
            continue
        if name in _ANIM_SLOTS:
            if not os.path.isdir(os.path.join(asset_dir,
                                              _ANIM_SLOTS[name][0])):
                missing.append(name)
            continue
        fn = _TEXTURE_FILES.get(name)
        if fn is None or not os.path.exists(os.path.join(asset_dir, fn)):
            missing.append(name)
    return missing


def build_pair_pool(scene: Scene, asset_dir=DEFAULT_ASSET_DIR,
                    dual: bool = True):
    """Build the (diffuse, normal) pair pool for a scene's materials (see
    ops.sampling.PairPool). Static material pairs are deduplicated into
    the big class; animated materials get one small-class pair per
    animation frame (paired with the material's own normal map).

    Returns (pool, mat_pair (M,) int32, anim_specs) where anim_specs maps
    material index -> (first_pair_index, frame_count, fps)."""
    chains, anim_frames = load_texture_chains(scene.texture_names, asset_dir)
    mb = scene.material_bank
    dmap = np.asarray(mb.diffuse_map_index)
    nmap = np.asarray(mb.normal_map_index)
    M = len(dmap)

    big_pairs = []  # (diffuse chain, normal chain)
    key_to_idx = {}
    small_pairs = []
    mat_pair = np.zeros(M, np.int32)
    anim_local = {}  # mat -> (local first index in small_pairs, count, fps)
    for m in range(M):
        d, n = int(dmap[m]), int(nmap[m])
        if d in anim_frames:
            frames, fps = anim_frames[d]
            anim_local[m] = (len(small_pairs), len(frames), fps)
            for fc in frames:
                small_pairs.append((fc, chains[n]))
        else:
            key = (d, n)
            if key not in key_to_idx:
                key_to_idx[key] = len(big_pairs)
                big_pairs.append((chains[d], chains[n]))
            mat_pair[m] = key_to_idx[key]
    n_big = len(big_pairs)
    for m, (first, count, fps) in anim_local.items():
        mat_pair[m] = n_big + first
    anim_specs = {m: (n_big + first, count, fps)
                  for m, (first, count, fps) in anim_local.items()}
    pool = sampling.PairPool.build(big_pairs + small_pairs, n_big,
                                   dual=dual)
    return pool, mat_pair, anim_specs


def load_sky_cubemap(path: str) -> np.ndarray:
    """(6, S, S, 4) float [0,1] faces from a DDS cubemap file, D3D face
    order — the LoadTextures path for gCubeMap (CRYCHIC.cpp:960 requests
    snowcube1024.dds, which the reference repo does not ship; any DDS
    cubemap slots in here)."""
    from ..io.dds import load_dds

    tex = load_dds(path)
    if not tex.is_cubemap:
        raise ValueError(f"{path} is not a cubemap")
    faces = np.stack([f[0] for f in tex.faces])
    if faces.dtype == np.uint8:
        return faces.astype(np.float32) / 255.0
    # HDR formats (BC6H) decode to float32 linear values — use directly.
    return faces.astype(np.float32)


def build_device_scene(scene: Scene, asset_dir=DEFAULT_ASSET_DIR,
                       lights=None, ssao_dims=(540, 960),
                       sky_cubemap_path: str = None,
                       dual_mip_rows: bool = True) -> fr.DeviceScene:
    if lights is None:
        lights = build_reference_lights()
    pool, mat_pair, anim_specs = build_pair_pool(scene, asset_dir,
                                                 dual=dual_mip_rows)
    mb = scene.material_bank
    if sky_cubemap_path:
        cubemap = sampling.pack_cubemap(load_sky_cubemap(sky_cubemap_path))
    else:
        cubemap = sampling.pack_cubemap(sampling.procedural_sky_cubemap(256))
    return fr.attach_draw_statics(fr.DeviceScene(
        opaque=fr.DeviceDraw.from_host(scene.opaque),
        shadow=fr.DeviceDraw.from_host(scene.shadow),
        alpha=(fr.DeviceDraw.from_host(scene.alpha)
               if scene.alpha is not None else None),
        mat_albedo=jnp.asarray(mb.diffuse_albedo),
        mat_fresnel=jnp.asarray(mb.fresnel_r0),
        mat_roughness=jnp.asarray(mb.roughness),
        mat_metalness=jnp.asarray(mb.metalness),
        mat_transform=jnp.asarray(mb.mat_transform),
        mat_pair=jnp.asarray(mat_pair),
        pair_data=pool.data,
        cubemap=jnp.asarray(cubemap),
        light_strength=jnp.asarray(lights.strength),
        light_direction=jnp.asarray(lights.direction),
        light_position=jnp.asarray(lights.position),
        light_falloff_start=jnp.asarray(lights.falloff_start),
        light_falloff_end=jnp.asarray(lights.falloff_end),
        light_spot_power=jnp.asarray(lights.spot_power),
        ambient=jnp.asarray(lights.ambient),
        ssao_offsets=jnp.asarray(ssao_ops.build_offset_vectors()),
        ssao_random_field=jnp.asarray(ssao_ops.build_random_field(
            ssao_ops.build_random_vector_texture(), *ssao_dims)),
        ssao_blur_weights=jnp.asarray(ssao_ops.calc_gauss_weights(2.5)),
        n_big_pairs=pool.n_big,
    )), anim_specs


def choose_rasterizer(cfg: RenderConfig, platform: str) -> RenderConfig:
    """Resolve and check cfg's rasterizer for a JAX backend: use_pallas
    None becomes the backend's own (the kernel on the GPU, the XLA
    reference on the CPU); the kernel runs on the CPU only in interpret
    mode, and interpret mode never runs on the GPU."""
    import dataclasses as _dc

    use_kernel = rp.kernel_for_backend(platform)
    if cfg.use_pallas is None:
        cfg = _dc.replace(cfg, use_pallas=use_kernel)
    if cfg.pallas_interpret and platform != "cpu":
        raise ValueError("pallas_interpret is for CPU tests; the kernel "
                         f"compiles for {platform!r}")
    if cfg.use_pallas and not use_kernel and not cfg.pallas_interpret:
        raise ValueError(f"the raster kernel does not compile for "
                         f"{platform!r}; set pallas_interpret=True to run "
                         f"it in the interpreter")
    return cfg


class Renderer:
    """Owns the device scene + compiled frame fn; produces frames."""

    def __init__(self, scene: Scene, cfg: RenderConfig,
                 camera: Camera = None, asset_dir=DEFAULT_ASSET_DIR,
                 lights=None, auto_capacity: bool = True,
                 sky_cubemap_path: str = None):
        if sky_cubemap_path and cfg.procedural_sky:
            # a file-loaded sky implies sampling it (cfg selects the path
            # inside the jitted frame)
            import dataclasses as _dc

            cfg = _dc.replace(cfg, procedural_sky=False)
        self.scene = scene
        self.cfg = choose_rasterizer(cfg, jax.default_backend())
        self.camera = camera or self._default_camera()
        self.light_dir0 = (lights.direction[0] if lights is not None
                           else build_reference_lights().direction[0])
        self.device_scene, self.anim_specs = build_device_scene(
            scene, asset_dir, lights,
            ssao_dims=(self.cfg.ssao_height, self.cfg.ssao_width),
            sky_cubemap_path=sky_cubemap_path,
            dual_mip_rows=self.cfg.dual_mip_rows)
        self._base_mat_pair = np.asarray(self.device_scene.mat_pair)
        self._auto_capacity = auto_capacity
        if auto_capacity:
            self._autosize_capacity()
        cfg = self.cfg
        n_op = self.scene.opaque.num_instances
        n_sh = self.scene.shadow.num_instances
        n_al = (self.scene.alpha.num_instances
                if self.scene.alpha is not None else 0)

        def frame_packed(scene, packed):
            consts = self._unpack_frame_constants(packed, n_op, n_sh, n_al)
            return fr.render_frame(scene, consts, cfg)

        self._frame_fn = jax.jit(frame_packed)
        self._stats = []

    def capacity_requirements(self, total_time: float = 0.0) -> dict:
        """Exact (tile, triangle) pair counts for the current camera —
        what pair_capacity / shadow_pair_capacity must exceed, else the
        rasterizer silently drops geometry."""
        consts = self.frame_constants(total_time)
        req = jax.jit(functools.partial(
            fr.capacity_requirements, cfg=self.cfg))(
                self.device_scene, consts)
        return {k: int(v) for k, v in req.items()}

    def _autosize_capacity(self):
        """Size the static rasterizer capacities from the scene: headroom
        over the initial camera's exact pair counts — over-capacity frames
        become impossible at construction instead of silently dropping
        triangles, and oversized configs stop paying for sort/record work
        they never use."""
        import dataclasses as _dc

        req = self.capacity_requirements(0.0)

        def size(needed):
            # 1.5x headroom rounded to 64k: the bin sort's cost scales
            # with the STATIC capacity, so pow2 rounding (up to 2x slack
            # on top of the 2x headroom) measurably taxed the shadow pass
            return max(1 << 14, -(-int(needed * 1.5) // 65536) * 65536)

        kw = dict(pair_capacity=size(req["main_pairs"]),
                  shadow_pair_capacity=size(req["shadow_pairs"]))
        # tile-compacted shading: capacity in occupied (8, 128) shade
        # tiles, 1.25x pose headroom rounded to 64 (the compiled shape
        # scales the resolve's + PCF's gather rows LINEARLY — issued
        # rows are min(1, occupancy * headroom) of the screen, and
        # occupancy is ~52-54% on the full configs, so 1.5x headroom
        # forfeited a third of the compaction; ensure_capacity grows +
        # recompiles loudly when a pose outruns 1.25x); capped at the
        # full tile grid, where the compacted path would only add its
        # (tiny) compaction overhead to a full-screen resolve
        nt_full = (-(-self.cfg.height // fr.SHADE_TILE_H)
                   * -(-self.cfg.width // fr.SHADE_TILE_W))
        cb = min(nt_full, max(64, -(-int(req["shade_tiles"] * 1.25)
                                    // 64) * 64))
        kw["shade_tile_capacity"] = cb
        if self.cfg.ssao_enabled:
            # tile-compacted SSAO occlusion (same sizing discipline on
            # the (8, 32) HALF-res tile grid)
            snt_full = (-(-self.cfg.ssao_height // fr.SSAO_TILE_H)
                        * -(-self.cfg.ssao_width // fr.SSAO_TILE_W))
            scb = min(snt_full, max(64, -(-int(req["ssao_tiles"] * 1.25)
                                          // 64) * 64))
            kw["ssao_tile_capacity"] = scb
        if not fr.uses_kernel(self.cfg):
            # the XLA path truncates per-tile runs at bin_cap — size BOTH
            # the main and the shadow caps (an undersized shadow_bin_cap
            # silently drops shadow casters)
            kw["bin_cap"] = max(
                64, -(-(req["main_max_tile"] * 2) // 32) * 32)
            kw["shadow_bin_cap"] = max(
                64, -(-(req["shadow_max_tile"] * 2) // 32) * 32)
        self.cfg = _dc.replace(self.cfg, **kw)

    def resize(self, width: int, height: int):
        """The OnResize analogue (/root/reference/Common/d3dApp.cpp:141 +
        CRYCHIC::OnResize, CRYCHIC.cpp:110-128): rebuild every
        resolution-dependent piece of state — camera lens aspect (+ its
        culling frustum, derived per frame), the SSAO random-vector field
        at the new half-res grid, the auto-sized rasterizer capacities —
        and drop the compiled frame function. The next render() compiles
        the new shapes (an XLA recompile of seconds to a minute — the
        D3D12 equivalent rebuilds the swapchain + RTVs, which is
        milliseconds; static shapes are the trade)."""
        import dataclasses as _dc

        self.cfg = _dc.replace(self.cfg, width=width, height=height)
        self.camera.set_lens(self.camera.fov_y, width / height,
                             self.camera.near_z, self.camera.far_z)
        self.device_scene = _dc.replace(
            self.device_scene,
            ssao_random_field=jnp.asarray(ssao_ops.build_random_field(
                ssao_ops.build_random_vector_texture(),
                self.cfg.ssao_height, self.cfg.ssao_width)))
        if self._auto_capacity:
            self._autosize_capacity()
        self.rebind_frame_fn()

    def rebind_frame_fn(self):
        """Re-jit the frame fn against the CURRENT self.cfg. Must be
        called after any external mutation of self.cfg (the jit binds the
        cfg at construction; a stale binding silently renders with the
        old settings)."""
        cfg = self.cfg
        n_op = self.scene.opaque.num_instances
        n_sh = self.scene.shadow.num_instances
        n_al = (self.scene.alpha.num_instances
                if self.scene.alpha is not None else 0)

        def frame_packed(scene, packed):
            consts = self._unpack_frame_constants(packed, n_op, n_sh, n_al)
            return fr.render_frame(scene, consts, cfg)

        self._frame_fn = jax.jit(frame_packed)

    def ensure_capacity(self, total_time: float = 0.0):
        """check_capacity, but GROW instead of raising: when the pose
        outruns the autosized tile/pair capacities, re-autosize at this
        pose and re-jit the frame (one recompile), preserving the
        no-silent-truncation contract without killing the session."""
        try:
            return self.check_capacity(total_time)
        except RuntimeError:
            self._autosize_capacity()
            self.rebind_frame_fn()
            return self.check_capacity(total_time)

    def check_capacity(self, total_time: float = 0.0):
        """Raise if the current camera's frame would overflow the sized
        capacities (callable per frame from the app loop)."""
        req = self.capacity_requirements(total_time)
        if req["main_pairs"] > self.cfg.pair_capacity:
            raise RuntimeError(
                f"main raster overflow: {req['main_pairs']} pairs > "
                f"pair_capacity {self.cfg.pair_capacity}")
        if req["shadow_pairs"] > self.cfg.shadow_pair_capacity:
            raise RuntimeError(
                f"shadow raster overflow: {req['shadow_pairs']} pairs > "
                f"shadow_pair_capacity {self.cfg.shadow_pair_capacity}")
        xla_raster = not fr.uses_kernel(self.cfg)
        if xla_raster and \
                req["main_max_tile"] > self.cfg.bin_cap:
            raise RuntimeError(
                f"tile overflow: {req['main_max_tile']} triangles in one "
                f"tile > bin_cap {self.cfg.bin_cap}")
        if xla_raster and \
                req["shadow_max_tile"] > self.cfg.shadow_bin_cap:
            raise RuntimeError(
                f"shadow tile overflow: {req['shadow_max_tile']} triangles "
                f"in one tile > shadow_bin_cap {self.cfg.shadow_bin_cap}")
        if (self.cfg.shade_tile_capacity
                and req["shade_tiles"] > self.cfg.shade_tile_capacity):
            raise RuntimeError(
                f"shade tile overflow: {req['shade_tiles']} occupied tiles "
                f"> shade_tile_capacity {self.cfg.shade_tile_capacity}; "
                f"re-run _autosize_capacity")
        if (self.cfg.ssao_enabled and self.cfg.ssao_tile_capacity
                and req["ssao_tiles"] > self.cfg.ssao_tile_capacity):
            raise RuntimeError(
                f"ssao tile overflow: {req['ssao_tiles']} occupied tiles "
                f"> ssao_tile_capacity {self.cfg.ssao_tile_capacity}; "
                f"re-run _autosize_capacity")
        return req

    def _default_camera(self):
        cam = Camera()
        cam.set_position(0.0, 2.0, -15.0)  # CRYCHIC.cpp:46
        cam.set_lens(0.25 * np.pi, self.cfg.width / self.cfg.height,
                     1.0, 100.0)  # CRYCHIC.cpp:114
        return cam

    # -- per-frame host update (CRYCHIC::Update) ---------------------------
    def frame_constants_np(self,
                           total_time: float = 0.0) -> fr.FrameConstants:
        """Per-frame constants with HOST numpy leaves (the packed
        single-transfer render path consumes these directly)."""
        cam = self.camera
        view = cam.view
        proj = cam.proj
        ct = casc.fit_cascades(cam, self.light_dir0, self.cfg.shadow_map_size)

        opaque_vis = self._visibility(self.scene.opaque)
        shadow_vis = self._visibility(self.scene.shadow)
        alpha_vis = (self._visibility(self.scene.alpha)
                     if self.scene.alpha is not None else None)

        return fr.FrameConstants(
            alpha_visibility=alpha_vis,
            view=view.astype(np.float32),
            proj=proj.astype(np.float32),
            view_proj=(view @ proj).astype(np.float32),
            inv_proj=np.linalg.inv(proj).astype(np.float32),
            eye_pos=cam.position.astype(np.float32),
            cascade_view_projs=ct.view_projs.astype(np.float32),
            shadow_transforms=ct.shadow_transforms,
            opaque_visibility=opaque_vis,
            shadow_visibility=shadow_vis,
            total_time=np.float32(total_time),
        )

    def frame_constants(self, total_time: float = 0.0) -> fr.FrameConstants:
        c = self.frame_constants_np(total_time)
        return fr.FrameConstants(
            alpha_visibility=(jnp.asarray(c.alpha_visibility)
                              if c.alpha_visibility is not None else None),
            view=jnp.asarray(c.view), proj=jnp.asarray(c.proj),
            view_proj=jnp.asarray(c.view_proj),
            inv_proj=jnp.asarray(c.inv_proj),
            eye_pos=jnp.asarray(c.eye_pos),
            cascade_view_projs=jnp.asarray(c.cascade_view_projs),
            shadow_transforms=jnp.asarray(c.shadow_transforms),
            opaque_visibility=jnp.asarray(c.opaque_visibility),
            shadow_visibility=jnp.asarray(c.shadow_visibility),
            total_time=jnp.float32(c.total_time),
        )

    def _visibility(self, draw) -> np.ndarray:
        """Per-instance frustum culling (UpdateInstanceData,
        CRYCHIC.cpp:515-557), vectorized over all instances. Non-cullable
        instances (the OpaqueShadow layer) always pass, so shadows of
        off-screen casters stay correct (CRYCHIC.cpp:543-544)."""
        if not self.cfg.frustum_culling:
            return np.ones(draw.num_instances, np.float32)
        from ..models.camera import cull_instances

        frustum = BoundingFrustum(self.camera.proj)
        inv_view = np.linalg.inv(self.camera.view)
        inv_worlds = np.linalg.inv(draw.worlds)
        vis = cull_instances(frustum, inv_view, inv_worlds,
                             draw.bounds_center, draw.bounds_extents)
        return (vis | ~draw.cullable).astype(np.float32)

    # -- frame -------------------------------------------------------------
    def _animate_materials(self, total_time: float):
        """Cycle animated texture slots (BoltAnim/FireAnim frame sequences)
        by rewriting material->pair indices; cheap host-side update, no
        recompile (shapes unchanged)."""
        if not self.anim_specs:
            return
        pair = self._base_mat_pair.copy()
        for mat, (base, count, fps) in self.anim_specs.items():
            frame = int(total_time * fps) % count
            pair[mat] = base + frame
        self.device_scene.mat_pair = jnp.asarray(pair)

    # -- packed per-frame constants transfer --------------------------------
    # FrameConstants is a 10-leaf pytree; shipping 10 small arrays per
    # frame pays 10 host-to-device transfers. The D3D12 analogue is the
    # single UploadBuffer PassConstants write. render() therefore packs
    # every leaf into ONE flat f32 vector (one transfer) and unpacks with
    # free slices inside the jit (its cost on the GPU is not yet
    # measured; ROADMAP S6).

    def _pack_frame_constants(self, c: fr.FrameConstants) -> np.ndarray:
        parts = [np.asarray(c.view, np.float32).ravel(),
                 np.asarray(c.proj, np.float32).ravel(),
                 np.asarray(c.view_proj, np.float32).ravel(),
                 np.asarray(c.inv_proj, np.float32).ravel(),
                 np.asarray(c.eye_pos, np.float32).ravel(),
                 np.asarray(c.cascade_view_projs, np.float32).ravel(),
                 np.asarray(c.shadow_transforms, np.float32).ravel(),
                 np.float32([c.total_time]).ravel(),
                 np.asarray(c.opaque_visibility, np.float32).ravel(),
                 np.asarray(c.shadow_visibility, np.float32).ravel()]
        if c.alpha_visibility is not None:
            parts.append(np.asarray(c.alpha_visibility, np.float32).ravel())
        return np.concatenate(parts)

    def _unpack_frame_constants(self, packed, n_op: int, n_sh: int,
                                n_al: int) -> fr.FrameConstants:
        """Inverse of _pack_frame_constants; traced (pure slices)."""
        o = [0]

        def take(n, shape=None):
            v = packed[o[0]:o[0] + n]  # static python offsets
            o[0] += n
            return v.reshape(shape) if shape else v

        return fr.FrameConstants(
            view=take(16, (4, 4)), proj=take(16, (4, 4)),
            view_proj=take(16, (4, 4)), inv_proj=take(16, (4, 4)),
            eye_pos=take(3), cascade_view_projs=take(64, (4, 4, 4)),
            shadow_transforms=take(64, (4, 4, 4)),
            total_time=take(1)[0],
            opaque_visibility=take(n_op),
            shadow_visibility=take(n_sh),
            alpha_visibility=take(n_al) if n_al else None)

    def render(self, total_time: float = 0.0) -> jnp.ndarray:
        self._animate_materials(total_time)
        packed = self._pack_frame_constants(self.frame_constants_np(
            total_time))
        return self._frame_fn(self.device_scene, jnp.asarray(packed))

    def viewer_step_fn(self, disp_rows: int, disp_cols: int):
        """One jitted dispatch for the interactive loop: the full frame,
        downsampled to a (disp_rows, disp_cols, 3) uint8 display image
        (the full float32 frame is never copied to the host), plus
        the exact pair counts the frame expanded to — fetched 2-3 frames
        later by the pipelined viewer, which raises on overflow instead of
        silently dropping geometry. XLA CSEs the
        vertex/setup work shared between the frame and the capacity probe.

        Returns step(scene, consts) -> (disp u8, main_pairs, shadow_pairs).
        """
        H, W = self.cfg.height, self.cfg.width
        ys = jnp.asarray(np.linspace(0, H - 1, disp_rows).astype(np.int32))
        xs = jnp.asarray(np.linspace(0, W - 1, disp_cols).astype(np.int32))
        cfg = self.cfg

        def step(scene, consts):
            img = fr.render_frame(scene, consts, cfg)
            req = fr.capacity_requirements(scene, consts, cfg)
            disp = (jnp.clip(img[ys][:, xs, :3], 0.0, 1.0) * 255.0
                    + 0.5).astype(jnp.uint8)
            return disp, req["main_pairs"], req["shadow_pairs"]

        return jax.jit(step)

    def render_np(self, total_time: float = 0.0) -> np.ndarray:
        img = np.asarray(self.render(total_time))
        return np.clip(img, 0.0, 1.0)


def write_png(path: str, img: np.ndarray):
    """Minimal RGBA/gray PNG writer (no external deps)."""
    import struct
    import zlib

    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        color_type, channels = 0, 1
        img = img[..., None]
    elif img.shape[2] == 3:
        color_type, channels = 2, 3
    else:
        color_type, channels = 6, 4
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
