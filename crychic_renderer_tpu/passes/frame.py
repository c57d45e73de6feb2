"""The functional frame pipeline.

The D3D12 mutable-resource command-list model of CRYCHIC::Draw
(/root/reference/CRYCHIC.cpp:172-436) becomes one pure jitted function::

    render_frame(scene_device, frame_consts) -> (H, W, 4) image

with every render target an intermediate array. Pass order preserved from
the reference's deferred branch (SURVEY.md §1 data flow):

    [1] 4x cascade shadow depth renders       (DrawSceneToShadowMap)
    [2] normal/depth                          (DrawNormalsAndDepth)
    [3] SSAO occlusion (half-res) + 3x blur   (Ssao::ComputeSsao)
    [4] G-buffer                              (DrawGBuffer)
    [5] deferred PBR lighting + cascade PCF + ambient*SSAO + sky
        reflection, then sky pass             (CRYCHIC.cpp:238-279)

Deviations from the reference's schedule (same output):
- One visibility-buffer rasterization feeds passes [2], [4] and the main
  depth: the reference rasterizes the scene 3x (normals, G-buffer, deferred
  re-shade with DEPTH_EQUAL); with a functional pipeline those are all
  reads of the same (depth, triangle-id) buffer.
- Vertex transforms for all instances run as one dense batched
  multiply-add (exact f32 — see ops.shading.rowmat).
- Barriers/PSOs/descriptor heaps have no equivalent: data dependence is
  explicit in the dataflow graph.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..ops import rasterizer as rz
from ..ops import raster_pallas as rp
from ..ops import clipping
from ..ops import sampling, shading, shadows, ssao as ssao_ops


def uses_kernel(cfg: RenderConfig) -> bool:
    """cfg.use_pallas, with None resolved by the default backend."""
    if cfg.use_pallas is None:
        return rp.kernel_for_backend(jax.default_backend())
    return cfg.use_pallas


def raster_tile(cfg: RenderConfig):
    """(tile_h, tile_w) of the rasterizer ``cfg`` selects. Binning, the
    kernel's records and every capacity probe must use the same tile."""
    if not uses_kernel(cfg):
        return rz.TILE_H, rz.TILE_W
    return rp.TILE_H, rp.TILE_W


# ---------------------------------------------------------------------------
# Device-side containers (registered as pytrees via dataclass + tree_util)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceDraw:
    """Flattened draw buffers on device (see models.scene.DrawBuffers)."""

    positions: jnp.ndarray  # (V, 3)
    normals: jnp.ndarray
    tangents: jnp.ndarray
    uvs: jnp.ndarray
    vertex_instance: jnp.ndarray  # (V,) int32
    indices: jnp.ndarray  # (3T,) int32
    worlds: jnp.ndarray  # (D, 4, 4)
    tex_transforms: jnp.ndarray  # (D, 4, 4)
    material_indices: jnp.ndarray  # (D,) int32
    # Precomputed static per-corner tables (attach_draw_statics). worlds /
    # tex_transforms / mat_transform never change after scene build (only
    # mat_pair, visibility and the camera do — app/renderer.py), so the
    # world-space transforms AND the 3-row-per-triangle vertex gather are
    # frame-constant; precomputing them removes ~600k narrow gather rows
    # per frame (not yet measured on the GPU; ROADMAP S5). Bit-exact:
    # rowmat is per-row so it commutes with the corner gather, and a
    # triangle's 3 corners share one instance so the vis multiply
    # commutes too.
    tri_posw_h: jnp.ndarray = None  # (T, 3, 4) world pos, homogeneous
    tri_instance: jnp.ndarray = None  # (T,) int32 instance per triangle
    tri_rest: jnp.ndarray = None  # (T, 3, 12) [posW3|nrm3|tan3|uv2|mat1]

    def tree_flatten(self):
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self)), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def from_host(d):
        return DeviceDraw(
            positions=jnp.asarray(d.positions),
            normals=jnp.asarray(d.normals),
            tangents=jnp.asarray(d.tangents),
            uvs=jnp.asarray(d.uvs),
            vertex_instance=jnp.asarray(d.vertex_instance),
            indices=jnp.asarray(d.indices),
            worlds=jnp.asarray(d.worlds),
            tex_transforms=jnp.asarray(d.tex_transforms),
            material_indices=jnp.asarray(d.material_indices),
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceScene:
    opaque: DeviceDraw
    shadow: DeviceDraw
    # material bank
    mat_albedo: jnp.ndarray  # (M, 4)
    mat_fresnel: jnp.ndarray  # (M, 3)
    mat_roughness: jnp.ndarray  # (M,)
    mat_metalness: jnp.ndarray  # (M,)
    mat_transform: jnp.ndarray  # (M, 4, 4)
    mat_pair: jnp.ndarray  # (M,) int32 — (diffuse, normal) pair in the pool
    # textures (two-class analytic PAIR pool; see ops.sampling.PairPool)
    pair_data: jnp.ndarray  # (rows, 8) uint32
    cubemap: jnp.ndarray  # (6, S, S, 4) uint32 quad-packed
    # lights
    light_strength: jnp.ndarray  # (16, 3)
    light_direction: jnp.ndarray
    light_position: jnp.ndarray
    light_falloff_start: jnp.ndarray
    light_falloff_end: jnp.ndarray
    light_spot_power: jnp.ndarray
    ambient: jnp.ndarray  # (4,)
    # ssao setup
    ssao_offsets: jnp.ndarray  # (14, 3)
    # per-pixel random vectors at SSAO res, precomputed from the 256^2
    # MSVC-rand texture (frame-constant indices -> zero gathers per frame)
    ssao_random_field: jnp.ndarray  # (h, w, 3)
    ssao_blur_weights: jnp.ndarray  # (11,)
    # AlphaTested layer geometry (None when the scene has none)
    alpha: DeviceDraw = None
    n_big_pairs: int = 0  # static: count of big-class pairs in the pool

    def tree_flatten(self):
        children = tuple(getattr(self, f.name)
                         for f in dataclasses.fields(self))[:-1]
        return children, self.n_big_pairs

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, n_big_pairs=aux)

    @property
    def pair_pool(self):
        return sampling.PairPool(
            self.pair_data, self.n_big_pairs,
            dual=self.pair_data.shape[-1] == sampling.PAIR_ROW_DUAL)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FrameConstants:
    """Per-frame uniforms (the reference's PassConstants,
    FrameResource.h:29-51, minus what's derivable)."""

    view: jnp.ndarray  # (4, 4)
    proj: jnp.ndarray
    view_proj: jnp.ndarray
    inv_proj: jnp.ndarray
    eye_pos: jnp.ndarray  # (3,)
    cascade_view_projs: jnp.ndarray  # (4, 4, 4) light-space VPs
    shadow_transforms: jnp.ndarray  # (4, 4, 4) world -> shadow uv/z
    opaque_visibility: jnp.ndarray  # (D_opaque,) f32 1/0 cull mask
    shadow_visibility: jnp.ndarray  # (D_shadow,) f32
    alpha_visibility: jnp.ndarray = None  # (D_alpha,) f32, scenes with AT
    total_time: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(0.0))

    def tree_flatten(self):
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self)), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass
class LightConfig:
    """Static light counts (shader #defines in the reference)."""

    num_dir: int
    num_point: int
    num_spot: int


class _LightsView:
    """Adapter presenting DeviceScene light arrays with static counts to
    ops.shading functions."""

    def __init__(self, scene: DeviceScene, cfg: RenderConfig):
        self.strength = scene.light_strength
        self.direction = scene.light_direction
        self.position = scene.light_position
        self.falloff_start = scene.light_falloff_start
        self.falloff_end = scene.light_falloff_end
        self.spot_power = scene.light_spot_power
        self.num_dir = cfg.num_dir_lights
        self.num_point = cfg.num_point_lights
        self.num_spot = cfg.num_spot_lights


# ---------------------------------------------------------------------------
# Vertex stage
# ---------------------------------------------------------------------------

def vertex_stage(draw: DeviceDraw, visibility: jnp.ndarray,
                 view_proj: jnp.ndarray, mat_transform: jnp.ndarray):
    """All instances' vertices -> world space + clip space + final UVs.

    The VS of Default.hlsl/GeometryPass.hlsl:22-42 for every (item,
    instance) pair at once. Culled instances get clip w = 0, which the
    rasterizer's near-plane test discards (functional equivalent of the
    reference's instance-buffer compaction, CRYCHIC.cpp:528-553).
    """
    W = draw.worlds[draw.vertex_instance]  # (V, 4, 4)
    ph = jnp.concatenate(
        [draw.positions, jnp.ones_like(draw.positions[..., :1])], axis=-1)
    pos_w = shading.rowmat(ph, W)[:, :3]
    nrm_w = shading.rowmat(draw.normals, W[:, :3, :3])
    tan_w = shading.rowmat(draw.tangents, W[:, :3, :3])

    pos_wh = jnp.concatenate([pos_w, jnp.ones_like(pos_w[..., :1])], -1)
    clip = shading.rowmat(pos_wh, view_proj)
    vis_v = visibility[draw.vertex_instance]
    clip = clip * vis_v[:, None]

    # uv: (u, v, 0, 1) @ TexTransform @ MatTransform (Default.hlsl:69-70)
    uvh = jnp.concatenate(
        [draw.uvs, jnp.zeros_like(draw.uvs[..., :1]),
         jnp.ones_like(draw.uvs[..., :1])], axis=-1)
    T = draw.tex_transforms[draw.vertex_instance]
    M = mat_transform[draw.material_indices[draw.vertex_instance]]
    uv = shading.rowmat(shading.rowmat(uvh, T), M)[:, :2]
    return pos_w, nrm_w, tan_w, uv, clip


def draw_with_statics(draw: DeviceDraw,
                      mat_transform: jnp.ndarray = None) -> DeviceDraw:
    """Precompute the frame-constant per-corner tables (see the DeviceDraw
    field comment). mat_transform=None computes only the world-position
    table (enough for shadow casting); passing it also builds tri_rest
    for the main-layer record path."""
    W = draw.worlds[draw.vertex_instance]
    ph = jnp.concatenate(
        [draw.positions, jnp.ones_like(draw.positions[..., :1])], axis=-1)
    pos_w4 = shading.rowmat(ph, W)  # (V, 4) — w column kept (shadow path)
    tri_idx = draw.indices.reshape(-1, 3)
    rest = None
    if mat_transform is not None:
        nrm_w = shading.rowmat(draw.normals, W[:, :3, :3])
        tan_w = shading.rowmat(draw.tangents, W[:, :3, :3])
        uvh = jnp.concatenate(
            [draw.uvs, jnp.zeros_like(draw.uvs[..., :1]),
             jnp.ones_like(draw.uvs[..., :1])], axis=-1)
        T = draw.tex_transforms[draw.vertex_instance]
        M = mat_transform[draw.material_indices[draw.vertex_instance]]
        uv = shading.rowmat(shading.rowmat(uvh, T), M)[:, :2]
        mat = draw.material_indices[draw.vertex_instance].astype(jnp.float32)
        rest = jnp.concatenate(
            [pos_w4[:, :3], nrm_w, tan_w, uv, mat[:, None]], -1)[tri_idx]
    return dataclasses.replace(
        draw, tri_posw_h=pos_w4[tri_idx],
        tri_instance=draw.vertex_instance[tri_idx[:, 0]], tri_rest=rest)


def attach_draw_statics(scene: "DeviceScene") -> "DeviceScene":
    """Fill every draw's static corner tables (scene build time)."""
    return dataclasses.replace(
        scene,
        opaque=draw_with_statics(scene.opaque, scene.mat_transform),
        shadow=draw_with_statics(scene.shadow),
        alpha=(draw_with_statics(scene.alpha, scene.mat_transform)
               if scene.alpha is not None else None))


def tri_attrs(draw: DeviceDraw, visibility: jnp.ndarray,
              view_proj: jnp.ndarray, mat_transform: jnp.ndarray):
    """Per-triangle vertex records (T, 3, 16) for one main-layer draw.

    Fast path (statics attached): a dense (T,3,4)@(4,4) clip FMA + one
    per-triangle vis gather from the tiny instance table + a concat —
    bit-identical to the legacy per-vertex pipeline (see
    draw_with_statics) at ~1/5 the cost."""
    if draw.tri_rest is not None:
        poswh = jnp.concatenate(
            [draw.tri_posw_h[..., :3],
             jnp.ones_like(draw.tri_posw_h[..., :1])], -1)
        clip = shading.rowmat(poswh, view_proj)
        clip = clip * visibility[draw.tri_instance][:, None, None]
        return jnp.concatenate([clip, draw.tri_rest], -1)
    pw, nw, tw, uv, cl = vertex_stage(draw, visibility, view_proj,
                                      mat_transform)
    return build_tri_attrs(draw, pw, nw, tw, uv, cl)


def shadow_clip(draw: DeviceDraw, visibility: jnp.ndarray,
                cascade_vp: jnp.ndarray):
    """World positions of shadow casters projected by one cascade VP."""
    W = draw.worlds[draw.vertex_instance]
    ph = jnp.concatenate(
        [draw.positions, jnp.ones_like(draw.positions[..., :1])], axis=-1)
    pos_w = shading.rowmat(ph, W)
    clip = shading.rowmat(pos_w, cascade_vp)
    return clip * visibility[draw.vertex_instance][:, None]


def shadow_tri_world(draw: DeviceDraw, visibility: jnp.ndarray):
    """Per-triangle world-space homogeneous vertices (T, 3, 4), culled
    instances zeroed. Shared by all cascades: the world transform and the
    vertex->triangle gather (the expensive parts — 3 gather rows per
    triangle) run ONCE; each cascade then only pays a tiny dense
    (T, 3, 4) @ (4, 4) projection."""
    if draw.tri_posw_h is not None:
        # statics: the world transform + corner gather are precomputed;
        # per frame only the vis multiply remains.
        return (draw.tri_posw_h
                * visibility[draw.tri_instance][:, None, None])
    W = draw.worlds[draw.vertex_instance]
    ph = jnp.concatenate(
        [draw.positions, jnp.ones_like(draw.positions[..., :1])], axis=-1)
    pos_w = shading.rowmat(ph, W)
    pos_w = pos_w * visibility[draw.vertex_instance][:, None]
    return pos_w[draw.indices.reshape(-1, 3)]  # (T, 3, 4)


# ---------------------------------------------------------------------------
# Shadow pass
# ---------------------------------------------------------------------------

def render_one_shadow_map(scene: DeviceScene, shadow_visibility, vp,
                          cfg: RenderConfig, tri_world=None) -> jnp.ndarray:
    """One cascade's depth-only render -> (S, S) float32 depth.

    Depth bias replicates the shadow PSO's rasterizer state
    (CRYCHIC.cpp:1601-1603): constant bias 10000 (of 2^24 UNORM steps) +
    slope-scaled 2.0, applied per triangle from its depth plane slopes.
    """
    S = cfg.shadow_map_size
    if tri_world is None:
        tri_world = shadow_tri_world(scene.shadow, shadow_visibility)
    tris = rz.setup_tri_verts(shading.rowmat(tri_world, vp), None, S, S)
    tris = _shadow_bias(tris)
    bins = rz.bin_triangles(tris, S, S, cfg.shadow_pair_capacity)
    depth, _ = rz.rasterize_binned(tris, bins, S, S, cfg.shadow_bin_cap,
                                   with_ids=False)
    return depth


def _shadow_bias(tris):
    """Shadow PSO depth bias (CRYCHIC.cpp:1601-1603): 10000 UNORM24 steps +
    slope-scaled 2.0, from the triangle's depth-plane slopes."""
    A, B, C, area2, _ = rz._edge_coeffs(tris.xy)
    inv_a2 = 1.0 / jnp.where(area2 == 0, 1.0, area2)
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    max_slope = jnp.maximum(jnp.abs(zA), jnp.abs(zB))
    bias = 10000.0 / (1 << 24) + 2.0 * max_slope
    return tris._replace(z=jnp.clip(tris.z + bias[:, None], 0.0, 1.0))


def shadow_atlas_tris(scene: DeviceScene, shadow_visibility,
                      vps: jnp.ndarray, cfg: RenderConfig, tri_world=None):
    """Screen-space triangle setup for the (S, k*S) cascade atlas: every
    cascade's projected triangles, xy shifted into its atlas column, with
    the shadow PSO depth bias applied. Returns (tris, xrange) where xrange
    is the per-triangle column guard — a triangle extending past its
    cascade's viewport must not rasterize into the neighbor's atlas column
    (the per-cascade path gets this from its own viewport bounds)."""
    S = cfg.shadow_map_size
    k = vps.shape[0]
    if tri_world is None:
        tri_world = shadow_tri_world(scene.shadow, shadow_visibility)
    tris_list = []
    for c in range(k):
        t = rz.setup_tri_verts(shading.rowmat(tri_world, vps[c]),
                               None, S, S)
        # shift into atlas column c
        t = t._replace(xy=t.xy + jnp.asarray([c * S, 0.0], jnp.float32))
        tris_list.append(t)
    tris = rz.ScreenTris(
        xy=jnp.concatenate([t.xy for t in tris_list]),
        z=jnp.concatenate([t.z for t in tris_list]),
        inv_w=jnp.concatenate([t.inv_w for t in tris_list]),
        valid=jnp.concatenate([t.valid for t in tris_list]),
    )
    tris = _shadow_bias(tris)
    T1 = tris.xy.shape[0] // k
    col = jnp.repeat(jnp.arange(k, dtype=jnp.float32), T1)
    return tris, (col * S, (col + 1) * S)


def render_shadow_atlas(scene: DeviceScene, shadow_visibility,
                        vps: jnp.ndarray, cfg: RenderConfig) -> jnp.ndarray:
    """The given cascades rasterized in ONE pass into a horizontal
    (S, k*S) atlas (one binning + one kernel launch instead of k), then
    split to (k, S, S). The D3D12 reference records k sequential depth
    passes (DrawSceneToShadowMap, CRYCHIC.cpp:2479); one wider launch
    amortizes binning and gives the kernel k times the tiles.

    vps: (k, 4, 4) light view-proj per cascade (k static)."""
    S = cfg.shadow_map_size
    k = vps.shape[0]
    tris, xrange = shadow_atlas_tris(scene, shadow_visibility, vps, cfg)
    depth, _ = rp.rasterize_pallas(tris, k * S, S,
                                   cfg.shadow_pair_capacity,
                                   with_ids=False,
                                   interpret=cfg.pallas_interpret,
                                   xrange=xrange)
    return jnp.stack([depth[:, c * S:(c + 1) * S] for c in range(k)])


def render_shadow_maps(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig) -> jnp.ndarray:
    """4 cascade depth-only renders -> (4, S, S) float32 depth."""
    if uses_kernel(cfg):
        return render_shadow_atlas(scene, consts.shadow_visibility,
                                   consts.cascade_view_projs, cfg)

    tri_world = shadow_tri_world(scene.shadow, consts.shadow_visibility)

    def one_cascade(vp):
        return render_one_shadow_map(scene, consts.shadow_visibility, vp,
                                     cfg, tri_world=tri_world)

    return jax.vmap(one_cascade)(consts.cascade_view_projs)


def _mat_select(table: jnp.ndarray, mat: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel material attribute lookup as one-hot selects — the
    material table is tiny (<= 16 rows), so M dense selects replace a
    per-pixel gather (not yet measured on the GPU; ROADMAP S5)."""
    M = table.shape[0]
    expand = table.ndim > 1
    out = None
    for m in range(M):
        sel = mat == m
        if expand:
            sel = sel[..., None]
        term = jnp.where(sel, table[m], 0 if out is not None else table[m] * 0)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Geometry / attribute interpolation (the visibility-buffer resolve)
# ---------------------------------------------------------------------------

# Invalid pixels' record gathers fan out over this many duplicated copies
# of record row 0 (value-identical; kills gather hot-row contention).
_DEAD_SPREAD = 1024

def vertex_records(draw: DeviceDraw, pos_w, nrm_w, tan_w, uv, clip):
    """Per-VERTEX records (V, 16): [clip4 | posW3 | nrm3 | tan3 | uv2 |
    mat1] — the clip-space-linear quantities near-plane clipping
    interpolates (ops.clipping) and the resolve consumes."""
    mat = draw.material_indices[draw.vertex_instance].astype(jnp.float32)
    return jnp.concatenate(
        [clip, pos_w, nrm_w, tan_w, uv, mat[:, None]], axis=-1)


def build_tri_attrs(draw: DeviceDraw, pos_w, nrm_w, tan_w, uv, clip):
    """Per-triangle vertex records (T, 3, 16) — vertex_records gathered to
    triangles (3 row gathers per triangle; parallel.sharded shards this
    gather by triangle ranges)."""
    tri_idx = draw.indices.reshape(-1, 3)
    vrec = vertex_records(draw, pos_w, nrm_w, tan_w, uv, clip)
    return vrec[tri_idx]  # (T, 3, 16) row gathers


def _build_resolve_records(tris: rz.ScreenTris, tri_attr: jnp.ndarray):
    """The 64-wide per-TRIANGLE resolve record table + dead-spread rows.

    Everything a pixel needs packed into ONE row (screen xy + 1/w + 3
    vertices' attrs + material): a single row gather per pixel. Hot-row
    spread: tid < 0 (sky — about half of a frame's pixels) would clamp to
    row 0, and gathers that all hit one row serialize; _DEAD_SPREAD
    copies of row 0 fan invalid pixels out — gathered VALUES are
    identical, so this is bit-exact. (Neither is measured on the GPU
    yet; ROADMAP S5.)"""
    a = tri_attr[:, :, 4:]  # (T, 3, 12): posW3 nrm3 tan3 uv2 mat1
    rec = jnp.concatenate([
        tris.xy.reshape(-1, 6), tris.inv_w,             # 0:9
        a[:, 0, 0:3], a[:, 1, 0:3], a[:, 2, 0:3],       # 9:18 posW
        a[:, 0, 3:6], a[:, 1, 3:6], a[:, 2, 3:6],       # 18:27 nrm
        a[:, 0, 6:9], a[:, 1, 6:9], a[:, 2, 6:9],       # 27:36 tan
        a[:, 0, 9:11], a[:, 1, 9:11], a[:, 2, 9:11],    # 36:42 uv
        a[:, 0, 11:12],                                 # 42 material
    ], axis=-1)
    rec = jnp.pad(rec, ((0, 0), (0, 64 - rec.shape[1])))
    T = rec.shape[0]
    rec = jnp.concatenate([rec, jnp.tile(rec[0:1], (_DEAD_SPREAD, 1))])
    return rec, T


def _resolve_core(scene: DeviceScene, consts: FrameConstants,
                  cfg: RenderConfig, rec, T: int, tid, px, py, pix):
    """The per-pixel resolve: record gather -> perspective barycentric
    interpolation -> per-primitive uv derivatives -> texture sampling ->
    G-buffer planes. Shape-generic: tid/px/py/pix may be full-screen
    (H, W) grids OR tile-compacted (CB, 1024) lane blocks — every op here
    is per-pixel math or a flat-index gather."""
    valid = tid >= 0
    safe_tid = jnp.where(valid, jnp.maximum(tid, 0),
                         T + pix % _DEAD_SPREAD)
    r = rec[safe_tid]  # (..., 64) — the one per-pixel gather

    xy = r[..., :6].reshape(r.shape[:-1] + (3, 2))
    inv_w = r[..., 6:9]
    b = rz.barycentrics_at(xy, px, py)  # (..., 3) screen-space
    wgt = b * inv_w
    den = wgt.sum(-1, keepdims=True)
    # sign-preserving guard: extrapolated barycentrics (a pixel whose
    # record is a fallback/mismatched triangle) can sum NEGATIVE;
    # clamping to +1e-20 would flip the sign and explode uv to ~1e19,
    # which leaks into neighbors through the uv derivatives
    wgt = wgt / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
    w0 = wgt[..., 0:1]
    w1 = wgt[..., 1:2]
    w2 = wgt[..., 2:3]

    def lerp3(base, width):
        return (w0 * r[..., base:base + width]
                + w1 * r[..., base + width:base + 2 * width]
                + w2 * r[..., base + 2 * width:base + 3 * width])

    pix_pos_w = lerp3(9, 3)
    pix_nrm_w = lerp3(18, 3)
    pix_tan_w = lerp3(27, 3)
    pix_uv = lerp3(36, 2)
    mat = r[..., 42].astype(jnp.int32)

    # Texture fetch: ONE pair pool serves diffuse + normal (the reference
    # samples both with gsamAnisotropicWrap, GeometryPass.hlsl:52-55).
    pool = scene.pair_pool
    pairidx = _mat_select(scene.mat_pair, mat)
    # Per-PRIMITIVE uv derivatives: evaluate THIS pixel's triangle at
    # (x+1, y) and (x, y+1) and difference — same-primitive helper-lane
    # evaluation, per-PIXEL rather than per-quad (hardware ddx/ddy are
    # 2x2-quad-aligned, so odd-column/row pixels deviate sub-texel in
    # LOD; like hardware, ddx/ddy never mix triangles — the previous
    # resolved-field finite difference mixed neighbor triangles at
    # silhouettes and needed a cross-band halo row). Pure
    # per-pixel math — no neighbor reads — which is also what makes
    # tile-compacted shading (shade_tile_capacity) possible.
    def uv_at(px_, py_):
        b2 = rz.barycentrics_at(xy, px_, py_)
        w = b2 * inv_w
        den2 = w.sum(-1, keepdims=True)
        w = w / jnp.where(jnp.abs(den2) < 1e-20, 1e-20, den2)
        return (w[..., 0:1] * r[..., 36:38] + w[..., 1:2] * r[..., 38:40]
                + w[..., 2:3] * r[..., 40:42])

    duv_x = uv_at(px + 1.0, py) - pix_uv
    duv_y = uv_at(px, py + 1.0) - pix_uv
    # Dead-pixel TEXTURE probe spread: invalid (sky) pixels' record-0
    # extrapolated uv scatters their texture gathers across the whole
    # pool even though their sampled colors are never used (the frame
    # composition overwrites invalid pixels with the sky). Substitute a
    # compact ~1024-quad window at mip 0 for the SAMPLER INPUT only —
    # valid pixels' uv, duv and probes are bit-identical.
    dead3 = ~valid[..., None]
    ix = px.astype(jnp.int32)
    iy = py.astype(jnp.int32)
    uv_dead = jnp.stack([((ix % 32).astype(jnp.float32) + 0.5) / 512.0,
                         ((iy % 32).astype(jnp.float32) + 0.5) / 512.0],
                        axis=-1)
    samp_uv = jnp.where(dead3, uv_dead, pix_uv)
    duv_x = jnp.where(dead3, 0.0, duv_x)
    duv_y = jnp.where(dead3, 0.0, duv_y)
    if cfg.anisotropy > 1:
        if cfg.aniso_probes == 0:
            # reference-quality evaluation (max_aniso exact-trilinear
            # probes, 2*max_aniso gathers) — the quality yardstick the
            # production schedules are quantified against; never the
            # frame default
            diffuse_sample, normal_sample = sampling.sample_pair_aniso_ref(
                pool, pairidx, samp_uv, duv_x, duv_y, cfg.anisotropy)
        else:
            diffuse_sample, normal_sample = sampling.sample_pair_aniso(
                pool, pairidx, samp_uv, duv_x, duv_y, cfg.anisotropy,
                probes=cfg.aniso_probes)
    else:
        lod_uv = sampling.lod_from_derivatives(duv_x, duv_y)
        diffuse_sample, normal_sample = sampling.sample_pair_trilinear(
            pool, pairidx, samp_uv, lod_uv)

    albedo = _mat_select(scene.mat_albedo, mat) * diffuse_sample
    unit_n = shading.normalize(pix_nrm_w)
    bumped_n = shading.normal_sample_to_world(
        normal_sample[..., :3], unit_n, pix_tan_w)

    # DrawNormals.hlsl:91: view-space normal from the UNBUMPED vertex normal
    normal_v = shading.rowmat(unit_n, consts.view[:3, :3])

    # Uncovered pixels carry the reference's CLEAR values, exactly as its
    # render targets do: the normal map clears to view-space (0,0,1,0)
    # (CRYCHIC.cpp:2525 — what the SSAO pass sees for sky pixels) and the
    # G-buffer RTVs clear to black (CRYCHIC.cpp:2554). Previously these
    # pixels carried triangle-0's extrapolated attributes — a parity
    # deviation visible wherever SSAO's bilateral blur mixes silhouette
    # neighbors — and clear fills are also what lets tile-compacted
    # shading skip uncovered tiles entirely.
    v1 = valid[..., None]
    sky_n_v = jnp.zeros_like(normal_v).at[..., 2].set(1.0)
    return dict(
        pos_w=jnp.where(v1, pix_pos_w, 0.0),
        normal_w=jnp.where(v1, bumped_n, 0.0),
        normal_v=jnp.where(v1, normal_v, sky_n_v),
        albedo=jnp.where(v1, albedo, 0.0),
        roughness=jnp.where(
            v1, _mat_select(scene.mat_roughness, mat)[..., None], 0.0),
        metalness=jnp.where(
            v1, _mat_select(scene.mat_metalness, mat)[..., None], 0.0),
        shininess_alpha=jnp.where(v1, normal_sample[..., 3:4], 0.0),
        valid=valid,
    )


# G-buffer clear values per plane (the reference's RTV clears; see
# _resolve_core). Skipped tiles in the compacted path scatter-fill these.
_G_CLEAR = dict(pos_w=(0.0, 0.0, 0.0), normal_w=(0.0, 0.0, 0.0),
                normal_v=(0.0, 0.0, 1.0), albedo=(0.0,) * 4,
                roughness=(0.0,), metalness=(0.0,),
                shininess_alpha=(0.0,))

# compacted shade-tile geometry
SHADE_TILE_H = 8
SHADE_TILE_W = 128


def _resolve_compacted(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, rec, T: int, tid,
                       H: int, W: int, row_offset):
    """Tile-compacted resolve: gathers are issued ONLY for (8, 128) pixel
    tiles containing at least one covered pixel.

    A sparsely covered frame (a skull on sky) wastes most of a
    full-screen resolve on pixels whose result is discarded; compaction
    issues gathers for occupied tiles only (not yet measured on the GPU;
    ROADMAP S5).
    Compaction is static-shape: a cumsum over the ~2k tile-occupancy
    bits, one CB-row gather in, and one NT-row gather + one packed
    transpose out (all O(tiles), trivial next to the 2M per-pixel rows
    they remove; the inverse is a gather, not a scatter). cfg.
    shade_tile_capacity (CB) is autosized like the pair capacities, with
    the same check_capacity guard."""
    TS_H, TS_W = SHADE_TILE_H, SHADE_TILE_W
    Hp = -(-H // TS_H) * TS_H
    Wp = -(-W // TS_W) * TS_W
    tpad = jnp.pad(tid, ((0, Hp - H), (0, Wp - W)), constant_values=-1)
    nty, ntx = Hp // TS_H, Wp // TS_W
    NT = nty * ntx
    LANES = TS_H * TS_W
    tiles = tpad.reshape(nty, TS_H, ntx, TS_W).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(NT, LANES)
    tv = (tiles >= 0).any(axis=1)
    CB = min(int(cfg.shade_tile_capacity), NT)
    pos = jnp.cumsum(tv.astype(jnp.int32)) - 1
    kept = jnp.full((CB,), NT, jnp.int32)
    kept = kept.at[jnp.where(tv, pos, CB)].set(
        jnp.arange(NT, dtype=jnp.int32), mode="drop")
    tiles_s = jnp.concatenate(
        [tiles, jnp.full((1, LANES), -1, tiles.dtype)])
    tid_c = tiles_s[kept]  # (CB, LANES); sentinel slots all -1 (dead)
    lane = jnp.arange(LANES, dtype=jnp.int32)[None, :]
    x = (kept[:, None] % ntx) * TS_W + lane % TS_W
    y = (jnp.minimum(kept[:, None] // ntx, nty - 1) * TS_H
         + lane // TS_W)
    px = x.astype(jnp.float32) + 0.5
    py = y.astype(jnp.float32) + row_offset + 0.5
    pix = y * W + x  # only feeds the dead spread (% _DEAD_SPREAD)

    g = _resolve_core(scene, consts, cfg, rec, T, tid_c, px, py, pix)

    # Expansion back to full-res: GATHER-based inverse (not a scatter of
    # 7 planes), and ONE packed 16-channel transpose instead of one per
    # plane.
    names = ["pos_w", "normal_w", "normal_v", "albedo", "roughness",
             "metalness", "shininess_alpha"]
    packed = jnp.concatenate([g[n] for n in names], axis=-1)  # (CB,L,16)
    fill = jnp.concatenate(
        [jnp.asarray(_G_CLEAR[n], packed.dtype) for n in names])
    packed = jnp.concatenate(
        [packed, jnp.broadcast_to(fill, (1, LANES, fill.shape[0]))])
    # overflow tiles (pos >= CB — guarded by check_capacity) fall back to
    # the clear fill rather than aliasing another tile's slot
    inv = jnp.where(tv & (pos < CB), pos, CB)  # (NT,) slot per tile
    out = packed[inv]  # (NT, LANES, 16) — NT-row gather
    out = out.reshape(nty, ntx, TS_H, TS_W, -1)
    out = out.transpose(0, 2, 1, 3, 4).reshape(Hp, Wp, -1)[:H, :W]
    full, o = {}, 0
    for n in names:
        k = g[n].shape[-1]
        full[n] = out[..., o:o + k]
        o += k
    full["valid"] = tid >= 0
    return full


def resolve_gbuffer(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig, tris: rz.ScreenTris,
                    depth: jnp.ndarray, tid: jnp.ndarray,
                    tri_attr: jnp.ndarray, row_offset=0.0,
                    full_height: int = None, out_rows: int = None):
    """Gather the winning triangle's vertex data per pixel and build the
    G-buffer (GeometryPass.hlsl PS + GBuffer.hlsl encode, fused with the
    DrawNormals.hlsl view-space-normal output).

    tri_attr: (T, 3, 16) post-clip per-triangle vertex records (see
    build_tri_attrs; indices 4:15 are posW/nrm/tan/uv, 15 is material).

    Returns dict with posW (H,W,3), normalW bumped (H,W,3), normalV view
    (H,W,3), albedo (H,W,4), roughness, metalness (H,W,1), valid (H,W).
    Uncovered pixels carry the reference's render-target clear values
    (see _resolve_core).

    cfg.shade_tile_capacity switches to the tile-compacted path
    (_resolve_compacted): per-pixel gathers are issued only for occupied
    (8, 128) tiles — identical output, sized by Renderer autosizing.

    Band rendering (parallel.sharded): depth/tid may carry ONE halo row
    below the band; row_offset is the band's global first row,
    full_height the full image height, and out_rows trims the halo off
    every output (derivatives are per-primitive, so the halo row is no
    longer load-bearing; the plumbing is kept for the band shape
    contract)."""
    H, W = depth.shape
    if full_height is None:
        full_height = H
    rec, T = _build_resolve_records(tris, tri_attr)
    if cfg.shade_tile_capacity:
        g = _resolve_compacted(scene, consts, cfg, rec, T, tid, H, W,
                               row_offset)
    else:
        pix = (jnp.arange(H, dtype=jnp.int32)[:, None] * W
               + jnp.arange(W, dtype=jnp.int32)[None, :])
        # row_offset: band rendering evaluates barycentrics at GLOBAL
        # pixel rows so band output is bit-identical to single-chip
        px = (jnp.arange(W, dtype=jnp.float32) + 0.5)[None, :].repeat(H, 0)
        py = (jnp.arange(H, dtype=jnp.float32) + row_offset
              + 0.5)[:, None].repeat(W, 1)
        g = _resolve_core(scene, consts, cfg, rec, T, tid, px, py, pix)
    if out_rows is not None and out_rows != H:
        g = {k: v[:out_rows] for k, v in g.items()}
    return g


# ---------------------------------------------------------------------------
# SSAO
# ---------------------------------------------------------------------------

def ssao_inputs_half(cfg: RenderConfig, normal_v: jnp.ndarray,
                     depth: jnp.ndarray):
    """Downsample to the SSAO resolution, matching the reference's sampler
    footprints: normals point-sampled, depth box-filtered (see Ssao.hlsl
    samplers)."""
    k = cfg.ssao_scale
    sh_, sw_ = depth.shape[0] // k, depth.shape[1] // k
    n_half = normal_v[k - 1::k, k - 1::k][:sh_, :sw_]
    d_half = depth[: sh_ * k, : sw_ * k].reshape(sh_, k, sw_, k).mean((1, 3))
    return n_half, d_half


def ssao_blur(scene: DeviceScene, consts: FrameConstants, cfg: RenderConfig,
              access: jnp.ndarray, n_half: jnp.ndarray,
              d_half: jnp.ndarray) -> jnp.ndarray:
    """N two-pass (horizontal + vertical) bilateral blurs."""
    d_view = ssao_ops.ndc_depth_to_view(d_half, consts.proj[2, 2],
                                        consts.proj[3, 2])
    # off-screen neighbor taps read the white depth border (NDC 1 = the
    # far plane in view space) through gsamDepthMap — SsaoBlur.hlsl:112
    border = ssao_ops.ndc_depth_to_view(1.0, consts.proj[2, 2],
                                        consts.proj[3, 2])
    w = scene.ssao_blur_weights
    for _ in range(cfg.ssao_blur_count):
        access = ssao_ops.bilateral_blur(access, n_half, d_view, w, True,
                                         border_depth_view=border)
        access = ssao_ops.bilateral_blur(access, n_half, d_view, w, False,
                                         border_depth_view=border)
    return access


# SSAO occlusion needed EXACTLY at half-res pixels within this L-inf
# radius of any covered pixel: 15 (3 blur passes x radius 5 per axis)
# + 1 (the full-res bilinear upsample's half-res support) = 16 px. The
# SSAO tile is (8, 32) — finer than the shade tile's (8, 128) because
# the dilation makes wide tiles over-inclusive (fewer tiles survive at
# (8, 32) on config 5); the
# auxiliary in/out gathers stay O(tiles), trivial next to the 14 tap
# rows per pixel they remove.
SSAO_TILE_H = 8
SSAO_TILE_W = 32
_SSAO_DILATE_TILES = (2, 1)  # (16/8, ceil(16/32)) tile radii >= 16 px


def _ssao_tile_occupancy(valid_half, nty: int, ntx: int):
    """(h, w) half-res validity -> (NT,) bool: tiles within the blur
    dilation of any valid pixel (see _SSAO_DILATE_TILES)."""
    TS_H, TS_W = SSAO_TILE_H, SSAO_TILE_W
    h, w = valid_half.shape
    vp = jnp.pad(valid_half, ((0, nty * TS_H - h), (0, ntx * TS_W - w)))
    tv = vp.reshape(nty, TS_H, ntx, TS_W).any(axis=(1, 3))  # (nty, ntx)
    dy, dx = _SSAO_DILATE_TILES
    occ = jnp.pad(tv, ((dy, dy), (dx, dx)))
    out = jnp.zeros_like(tv)
    for oy in range(2 * dy + 1):
        for ox in range(2 * dx + 1):
            out = out | occ[oy:oy + nty, ox:ox + ntx]
    return out.reshape(-1)


def _ssao_occlusion_compacted(scene: DeviceScene, consts: FrameConstants,
                              cfg: RenderConfig, n_half, d_half, depth,
                              valid) -> jnp.ndarray:
    """Tile-compacted SSAO occlusion: the 14 tap gathers are issued ONLY
    for (8, 32) half-res tiles within the blur/upsample support of a
    covered pixel (same rationale and shape as _resolve_compacted: sky
    rows are not issued at all).

    EXACT on the full access map up to XLA constant-folding fp noise
    (measured <= 3e-6, zero when compared inside one jit): the fill for
    skipped tiles is 1.0, and a skipped pixel's true occlusion IS
    exactly 1.0 — its 14 taps only ever read far-plane depth (depth
    clears to 1.0; the border is opaque white 1.0; a tap's projected
    footprint is occlusionRadius*proj/z <= ~7 full-res texels at the far
    plane, far inside the 16-half-res-px dilation), so dist_z == 0 <
    surface_eps and occ == 0 for every tap. The residual noise source:
    the full-grid path's pixel uv is a compile-time constant XLA folds
    through the ray/projection FMAs, while the compacted uv derives from
    the runtime tile list. cfg.ssao_tile_capacity (CB)
    is autosized by Renderer with the same check_capacity guard as the
    pair capacities (the bound counts bbox-occupancy tiles + dilation,
    a superset of covered tiles)."""
    TS_H, TS_W = SSAO_TILE_H, SSAO_TILE_W
    h, w = d_half.shape
    k = cfg.ssao_scale
    nty, ntx = -(-h // TS_H), -(-w // TS_W)
    NT = nty * ntx
    LANES = TS_H * TS_W
    # half-res validity: any covered full-res pixel in the k x k block
    vh = valid[: h * k, : w * k].reshape(h, k, w, k).any(axis=(1, 3))
    tv = _ssao_tile_occupancy(vh, nty, ntx)

    CB = min(int(cfg.ssao_tile_capacity), NT)
    pos = jnp.cumsum(tv.astype(jnp.int32)) - 1
    kept = jnp.full((CB,), NT, jnp.int32)
    kept = kept.at[jnp.where(tv, pos, CB)].set(
        jnp.arange(NT, dtype=jnp.int32), mode="drop")

    def tileify(a, pad_value):
        a = a[..., None] if a.ndim == 2 else a
        ap = jnp.pad(a, ((0, nty * TS_H - h), (0, ntx * TS_W - w), (0, 0)),
                     constant_values=pad_value)
        t = ap.reshape(nty, TS_H, ntx, TS_W, -1).transpose(0, 2, 1, 3, 4)
        return t.reshape(NT, LANES, -1)

    # ONE packed (d, n, random_field) tile table + sentinel fill tile
    stack = jnp.concatenate([
        tileify(d_half, 1.0), tileify(n_half, 0.0),
        tileify(scene.ssao_random_field, 0.0)], axis=-1)  # (NT, LANES, 7)
    fill = jnp.asarray([1.0, 0, 0, 1.0, 0, 0, 0], stack.dtype)
    stack = jnp.concatenate(
        [stack, jnp.broadcast_to(fill, (1, LANES, 7))])
    sel = stack[kept]  # (CB, LANES, 7) — CB-row gather in
    d_c, n_c, rf_c = sel[..., 0], sel[..., 1:4], sel[..., 4:7]

    lane = jnp.arange(LANES, dtype=jnp.int32)[None, :]
    x = (kept[:, None] % ntx) * TS_W + lane % TS_W
    y = (jnp.minimum(kept[:, None] // ntx, nty - 1) * TS_H
         + lane // TS_W)
    U = (x.astype(jnp.float32) + 0.5) / w
    V = (y.astype(jnp.float32) + 0.5) / h

    acc = ssao_ops.ssao_occlusion(
        n_c, d_c, consts.proj, consts.inv_proj, scene.ssao_offsets,
        random_field=rf_c, tap_depth=depth, pixel_uv=(U, V))  # (CB, LANES)

    # expand: gather-based inverse (see _resolve_compacted); overflow
    # tiles (pos >= CB — guarded by check_capacity) take the 1.0 fill
    accp = jnp.concatenate([acc, jnp.ones((1, LANES), acc.dtype)])
    inv = jnp.where(tv & (pos < CB), pos, CB)
    out = accp[inv].reshape(nty, ntx, TS_H, TS_W)
    return out.transpose(0, 2, 1, 3).reshape(nty * TS_H,
                                             ntx * TS_W)[:h, :w]


def ssao_pass(scene: DeviceScene, consts: FrameConstants, cfg: RenderConfig,
              normal_v: jnp.ndarray, depth: jnp.ndarray,
              valid: jnp.ndarray = None) -> jnp.ndarray:
    """Half-res occlusion + N two-pass bilateral blurs -> (h, w) access.

    valid: optional (H, W) full-res coverage (tid >= 0). With
    cfg.ssao_tile_capacity set, occlusion tap gathers are issued only
    for occupied tiles (exact to <=3e-6 — see
    _ssao_occlusion_compacted)."""
    n_half, d_half = ssao_inputs_half(cfg, normal_v, depth)
    if cfg.ssao_tile_capacity and valid is not None:
        access = _ssao_occlusion_compacted(scene, consts, cfg, n_half,
                                           d_half, depth, valid)
    else:
        access = ssao_ops.ssao_occlusion(
            n_half, d_half, consts.proj, consts.inv_proj,
            scene.ssao_offsets, random_field=scene.ssao_random_field,
            tap_depth=depth)  # full-res taps (Ssao.hlsl samples the full
        # depth buffer with the linear border-white gsamDepthMap)
    return ssao_blur(scene, consts, cfg, access, n_half, d_half)


def _upsample_bilinear(img: jnp.ndarray, H: int, W: int) -> jnp.ndarray:
    """Half-res -> full-res bilinear (the lighting pass samples the SSAO map
    with gsamLinearClamp at full-res screen uv)."""
    return jax.image.resize(img, (H, W), method="bilinear")


# ---------------------------------------------------------------------------
# Lighting + sky
# ---------------------------------------------------------------------------

def _pcf_factor_compacted(cfg: RenderConfig, pos_w, valid, sf_fn):
    """Tile-compacted cascade PCF factor: the per-pixel window gathers
    are issued only for (8, 128) tiles containing a covered pixel. The
    factor is POINTWISE (no blur), so the needed set is exactly the
    resolve's shade tiles and cfg.shade_tile_capacity is reused. Output
    equals the dense map: live pixels evaluate identical math on
    identical values; dead (sky) pixels are 1.0 under the dense path's
    dead= mask and 1.0 via the skipped-tile fill here."""
    TS_H, TS_W = SHADE_TILE_H, SHADE_TILE_W
    H, W = valid.shape
    nty, ntx = -(-H // TS_H), -(-W // TS_W)
    NT, LANES = nty * ntx, TS_H * TS_W

    def tileify(a, pad_value):
        a = a[..., None] if a.ndim == 2 else a
        ap = jnp.pad(a, ((0, nty * TS_H - H), (0, ntx * TS_W - W), (0, 0)),
                     constant_values=pad_value)
        t = ap.reshape(nty, TS_H, ntx, TS_W, -1).transpose(0, 2, 1, 3, 4)
        return t.reshape(NT, LANES, -1)

    stack = jnp.concatenate(
        [tileify(pos_w, 0.0),
         tileify(valid.astype(pos_w.dtype), 0.0)], axis=-1)  # (NT, L, 4)
    tv = stack[..., 3].max(axis=1) > 0.5
    CB = min(int(cfg.shade_tile_capacity), NT)
    pos = jnp.cumsum(tv.astype(jnp.int32)) - 1
    kept = jnp.full((CB,), NT, jnp.int32)
    kept = kept.at[jnp.where(tv, pos, CB)].set(
        jnp.arange(NT, dtype=jnp.int32), mode="drop")
    stack = jnp.concatenate(
        [stack, jnp.zeros((1, LANES, 4), stack.dtype)])
    sel = stack[kept]  # (CB, LANES, 4) — CB-row gather in
    f = sf_fn(sel[..., :3], sel[..., 3] < 0.5)  # (CB, LANES)

    fp = jnp.concatenate([f, jnp.ones((1, LANES), f.dtype)])
    inv = jnp.where(tv & (pos < CB), pos, CB)
    out = fp[inv].reshape(nty, ntx, TS_H, TS_W)
    return out.transpose(0, 2, 1, 3).reshape(nty * TS_H,
                                             ntx * TS_W)[:H, :W]


def lighting_pass(scene: DeviceScene, consts: FrameConstants,
                  cfg: RenderConfig, g: dict, shadow_maps, ambient_access,
                  depth: jnp.ndarray, row_offset=0,
                  full_height: int = None,
                  shadow_factor=None) -> jnp.ndarray:
    """Deferred PBR lighting (DeferredShading.hlsl PS) + sky.

    row_offset/full_height support band rendering (parallel.sharded): the
    sky-ray NDC y must come from the GLOBAL pixel row. shadow_factor
    ((H, W), optional) overrides the internal PCF evaluation — the sharded
    fast preset computes it with cross-band halos for band-exactness.
    """
    H, W = depth.shape
    if full_height is None:
        full_height = H
    pos_w = g["pos_w"]
    normal = shading.normalize(g["normal_w"])
    albedo = g["albedo"]
    roughness = g["roughness"]
    metalness = g["metalness"]
    view = shading.normalize(consts.eye_pos - pos_w)
    fresnel_r0 = 0.04 * (1.0 - metalness) + albedo[..., :3] * metalness

    ambient = (ambient_access[..., None] * scene.ambient[None, None, :]
               * albedo)

    if cfg.shadows_enabled:
        if shadow_factor is not None:
            sf = shadow_factor
        elif cfg.fast_shadow_factor:
            # performance mode: evaluate the (smooth) PCF factor on a
            # half-res grid and upsample — the 16-tap filter is already a
            # blur, so the quality cost is at shadow silhouettes only
            sf_half = shadows.cascade_shadow_factor(
                shadow_maps, consts.shadow_transforms,
                pos_w[::2, ::2], consts.eye_pos,
                cfg.shadow_map_size, deferred_blend_quirk=cfg.deferred,
                soft_radius_texels=cfg.pcf_radius_texels,
                dead=~g["valid"][::2, ::2])
            sf = _upsample_bilinear(sf_half, H, W)
        else:
            def sf_fn(pw, dd):
                return shadows.cascade_shadow_factor(
                    shadow_maps, consts.shadow_transforms, pw,
                    consts.eye_pos, cfg.shadow_map_size,
                    deferred_blend_quirk=cfg.deferred,
                    soft_radius_texels=cfg.pcf_radius_texels, dead=dd)

            if cfg.shade_tile_capacity and row_offset == 0 \
                    and full_height == H:
                # single-chip: issue the PCF window gathers only for
                # covered tiles (the band path keeps the dense form —
                # its per-band occupancy is not what shade_tile_capacity
                # was sized for)
                sf = _pcf_factor_compacted(cfg, pos_w, g["valid"], sf_fn)
            else:
                sf = sf_fn(pos_w, ~g["valid"])
        sf = sf[..., None]
    else:
        sf = jnp.ones_like(roughness)

    lights = _LightsView(scene, cfg)
    # deferred shininess alpha is gBuffer2.w == 1 (GBuffer.hlsl:28);
    # forward uses the normal map alpha (Default.hlsl:159)
    alpha = jnp.ones_like(roughness) if cfg.deferred else g["shininess_alpha"]
    shininess = (1.0 - roughness) * alpha

    if cfg.use_pbr:
        direct = shading.pbr_shading(lights, normal, view, pos_w, albedo,
                                     roughness, metalness, sf)
    else:
        direct = shading.compute_lighting(lights, normal, view, pos_w,
                                          albedo, fresnel_r0, shininess,
                                          sf)
    direct = shading.tonemap_direct(direct)
    lit = ambient[..., :3] + direct

    if cfg.sky_enabled:
        # sky reflection on geometry (Default.hlsl:176-179) and the sky
        # pass for empty pixels (sky.hlsl:33-47 — the eye-centered sphere's
        # PosL is the view ray) are mutually exclusive per pixel, so ONE
        # cubemap gather serves both.
        r = shading.reflect(-view, normal)
        ndc_x = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W * 2.0 - 1.0
        ndc_y = (1.0 - (jnp.arange(H, dtype=jnp.float32) + row_offset + 0.5)
                 / full_height * 2.0)
        ndc = jnp.stack(
            [jnp.broadcast_to(ndc_x[None, :], (H, W)),
             jnp.broadcast_to(ndc_y[:, None], (H, W)),
             jnp.ones((H, W), jnp.float32),
             jnp.ones((H, W), jnp.float32)], axis=-1)
        inv_vp = jnp.linalg.inv(consts.view_proj)
        far_h = ndc @ inv_vp
        far_w = far_h[..., :3] / far_h[..., 3:4]
        ray = far_w - consts.eye_pos
        valid3 = g["valid"][..., None]
        cube_dir = jnp.where(valid3, r, ray)
        if cfg.procedural_sky:
            cube_col = sampling.procedural_sky_color(cube_dir)
        else:
            cube_col = sampling.sample_cubemap(scene.cubemap,
                                               cube_dir)[..., :3]
        fres = shading.schlick_fresnel(fresnel_r0, normal, r)
        lit = jnp.where(valid3, lit + shininess * fres * cube_col, cube_col)

    alpha_out = jnp.where(g["valid"][..., None], albedo[..., 3:4], 1.0)
    return jnp.concatenate([lit, alpha_out], axis=-1)


# ---------------------------------------------------------------------------
# Capacity diagnostics (jittable)
# ---------------------------------------------------------------------------

def main_view_tris(scene: DeviceScene, consts: FrameConstants,
                   cfg: RenderConfig):
    """Vertex stage + near clip + screen setup for the main view (the
    shared front half of render_frame and the capacity probes)."""
    tri_attr = tri_attrs(scene.opaque, consts.opaque_visibility,
                         consts.view_proj, scene.mat_transform)
    tri_attr, tri_valid = clipping.clip_near(
        tri_attr, jnp.ones(tri_attr.shape[0], bool))
    tris = rz.setup_tri_verts(tri_attr[..., :4], tri_valid,
                              cfg.width, cfg.height)
    return tris, tri_attr


# ---------------------------------------------------------------------------
# Alpha-tested layer (the ALPHA_TEST shader variants compiled at
# CRYCHIC.cpp:1205-1218: Default.hlsl / Shadows.hlsl clip(a - 0.1))
# ---------------------------------------------------------------------------

def alpha_view_tris(scene: DeviceScene, consts: FrameConstants,
                    cfg: RenderConfig):
    """Vertex stage + near clip for the AlphaTested layer (same pipeline
    as main_view_tris, over scene.alpha)."""
    tri_attr = tri_attrs(scene.alpha, consts.alpha_visibility,
                         consts.view_proj, scene.mat_transform)
    tri_attr, tri_valid = clipping.clip_near(
        tri_attr, jnp.ones(tri_attr.shape[0], bool))
    tris = rz.setup_tri_verts(tri_attr[..., :4], tri_valid,
                              cfg.width, cfg.height)
    return tris, tri_attr


def _alpha_peel(tris: rz.ScreenTris, uv_tri, mat_tri, scene: DeviceScene,
                px, py, n_peels: int, clip_thr: float):
    """Dense small-N rasterization of alpha-tested triangles with depth
    peeling: per pixel, the nearest fragment whose sampled alpha passes
    clip(a - thr).

    A GPU gets this for free (the PS clips before the depth test,
    Shadows.hlsl:49-65); a visibility-buffer rasterizer cannot, because
    coverage is decided without textures. The shape of the problem here:
    the AT layer is SMALL (a handful of fences/foliage quads), so an
    O(T_alpha x pixels) dense edge-function loop plus
    ``n_peels`` rounds of (winner-record gather + one texture row gather)
    is cheaper and simpler than threading texture fetches through the
    binned kernel. Fragments behind ``n_peels`` failing layers are
    dropped (documented approximation; 2 covers every two-sided fence).

    tris: (T,) screen triangles; uv_tri: (T, 3, 2); mat_tri: (T,).
    px/py: pixel-center coordinate grids (broadcastable to the output).
    Returns (z, idx): idx -1 where no passing fragment.
    """
    A, B, C, area2, top_left = rz._edge_coeffs(tris.xy)
    inv_a2 = 1.0 / jnp.where(area2 == 0, 1.0, area2)
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    zC = (C * tris.z * inv_a2[:, None]).sum(-1)
    T = tris.xy.shape[0]
    shape = jnp.broadcast_shapes(px.shape, py.shape)
    pxb = jnp.broadcast_to(px, shape)
    pyb = jnp.broadcast_to(py, shape)

    # 16-wide per-triangle record: xy(6) inv_w(3) uv(6) mat(1) — ONE row
    # gather per pixel per peel recovers the winner's interpolation data
    rec = jnp.concatenate([
        tris.xy.reshape(-1, 6), tris.inv_w,
        uv_tri[:, 0], uv_tri[:, 1], uv_tri[:, 2],
        mat_tri.astype(jnp.float32)[:, None],
    ], axis=-1)

    def nearest_above(zfloor):
        def body(t, carry):
            zb, ib = carry
            cov = jnp.ones(shape, bool)
            for e in range(3):
                E = A[t, e] * pxb + B[t, e] * pyb + C[t, e]
                cov &= (E > 0) | ((E == 0) & top_left[t, e])
            z = zA[t] * pxb + zB[t] * pyb + zC[t]
            cand = cov & tris.valid[t] & (z >= 0.0) & (z <= 1.0) \
                & (z > zfloor)
            better = cand & (z < zb)
            return (jnp.where(better, z, zb),
                    jnp.where(better, t, ib))
        z0 = jnp.full(shape, jnp.inf)
        i0 = jnp.full(shape, -1, jnp.int32)
        return jax.lax.fori_loop(0, T, body, (z0, i0))

    res_z = jnp.full(shape, jnp.inf)
    res_id = jnp.full(shape, -1, jnp.int32)
    resolved = jnp.zeros(shape, bool)
    zfloor = jnp.full(shape, -1.0)
    for _ in range(n_peels):
        zb, ib = nearest_above(zfloor)
        r = rec[jnp.maximum(ib, 0)]
        xy = r[..., :6].reshape(shape + (3, 2))
        b = rz.barycentrics_at(xy, pxb, pyb)
        wgt = b * r[..., 6:9]
        den = wgt.sum(-1, keepdims=True)
        # sign-preserving guard: extrapolated barycentrics (a pixel whose
        # record is a fallback/mismatched triangle) can sum NEGATIVE;
        # clamping to +1e-20 would flip the sign and explode uv to ~1e19,
        # which leaks into neighbors through the uv derivatives
        wgt = wgt / jnp.where(jnp.abs(den) < 1e-20, 1e-20, den)
        uv = (wgt[..., 0:1] * r[..., 9:11] + wgt[..., 1:2] * r[..., 11:13]
              + wgt[..., 2:3] * r[..., 13:15])
        mat = r[..., 15].astype(jnp.int32)
        pairidx = _mat_select(scene.mat_pair, mat)
        duv_x, duv_y = sampling.uv_derivatives(uv)
        lod = sampling.lod_from_derivatives(duv_x, duv_y)
        dsample, _ = sampling.sample_pair_trilinear(
            scene.pair_pool, pairidx, uv, lod)
        aval = dsample[..., 3] * _mat_select(scene.mat_albedo, mat)[..., 3]
        passing = (ib >= 0) & (aval - clip_thr >= 0.0)
        take = (~resolved) & passing
        res_z = jnp.where(take, zb, res_z)
        res_id = jnp.where(take, ib, res_id)
        resolved = resolved | take
        zfloor = jnp.where(ib >= 0, zb, jnp.inf)
    return res_z, res_id


def alpha_merge_main(scene: DeviceScene, consts: FrameConstants,
                     cfg: RenderConfig, depth, tid, tris, tri_attr,
                     row_offset=0.0):
    """Rasterize the AlphaTested layer and merge it into the opaque
    visibility buffer; AT triangle records are APPENDED to the screen-tri
    and attribute tables, so resolve_gbuffer shades AT winners through
    the exact same path (tid indexes the concatenated table).

    row_offset: first GLOBAL pixel row of `depth` (band rendering — the
    peel evaluates at global rows so bands match single-chip exactly)."""
    H, W = depth.shape
    a_tris, a_attr = alpha_view_tris(scene, consts, cfg)
    px = (jnp.arange(W, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.asarray(row_offset, jnp.float32)
          + jnp.arange(H, dtype=jnp.float32) + 0.5)[:, None]
    uv_tri = a_attr[:, :, 13:15]
    mat_tri = a_attr[:, 0, 15]
    az, aid = _alpha_peel(a_tris, uv_tri, mat_tri, scene, px, py,
                          cfg.alpha_peels, cfg.alpha_clip)
    t_base = tris.xy.shape[0]
    win = (aid >= 0) & (az < depth)
    depth = jnp.where(win, az, depth)
    tid = jnp.where(win, t_base + aid, tid)
    tris = rz.ScreenTris(
        xy=jnp.concatenate([tris.xy, a_tris.xy]),
        z=jnp.concatenate([tris.z, a_tris.z]),
        inv_w=jnp.concatenate([tris.inv_w, a_tris.inv_w]),
        valid=jnp.concatenate([tris.valid, a_tris.valid]),
    )
    tri_attr = jnp.concatenate([tri_attr, a_attr])
    return depth, tid, tris, tri_attr


def alpha_shadow_geom(scene: DeviceScene, consts: FrameConstants):
    """Cascade-independent inputs of the AT shadow punch, computed once:
    per-triangle world-space vertices plus the per-vertex uv (same
    transform chain as vertex_stage) gathered to triangles."""
    draw = scene.alpha
    tri_world = shadow_tri_world(draw, consts.alpha_visibility)
    if draw.tri_rest is not None:
        # statics: uv (tri_rest[..., 9:11]) and material ids are
        # frame-constant — reuse the precomputed corner tables.
        return (tri_world, draw.tri_rest[..., 9:11],
                draw.tri_rest[:, 0, 11].astype(jnp.int32))
    uvh = jnp.concatenate(
        [draw.uvs, jnp.zeros_like(draw.uvs[..., :1]),
         jnp.ones_like(draw.uvs[..., :1])], axis=-1)
    Tm = draw.tex_transforms[draw.vertex_instance]
    Mm = scene.mat_transform[draw.material_indices[draw.vertex_instance]]
    uv = shading.rowmat(shading.rowmat(uvh, Tm), Mm)[:, :2]
    tri_idx = draw.indices.reshape(-1, 3)
    uv_tri = uv[tri_idx]
    mat_tri = draw.material_indices[draw.vertex_instance][tri_idx[:, 0]]
    return tri_world, uv_tri, mat_tri


def alpha_punch_window(scene: DeviceScene, cfg: RenderConfig, tri_world,
                       uv_tri, mat_tri, vp):
    """One cascade's AT punch data: depth-peel the AT triangles inside a
    statically-sized window positioned over the layer's light-space
    bounding box. Returns (az (Wn, Wn), aid (Wn, Wn) int32, oy, ox) — the
    shadow map is NOT read, so this can run on a different device than the
    merge (parallel.sharded distributes cascades)."""
    S = cfg.shadow_map_size
    Wn = min(cfg.alpha_shadow_window, S)
    t = rz.setup_tri_verts(shading.rowmat(tri_world, vp), None, S, S)
    t = _shadow_bias(t)
    vx = jnp.where(t.valid[:, None, None], t.xy, jnp.inf)
    ox = jnp.clip(jnp.floor(vx[..., 0].min()).astype(jnp.int32) - 1,
                  0, S - Wn)
    oy = jnp.clip(jnp.floor(vx[..., 1].min()).astype(jnp.int32) - 1,
                  0, S - Wn)
    px = (ox.astype(jnp.float32)
          + jnp.arange(Wn, dtype=jnp.float32) + 0.5)[None, :]
    py = (oy.astype(jnp.float32)
          + jnp.arange(Wn, dtype=jnp.float32) + 0.5)[:, None]
    az, aid = _alpha_peel(t, uv_tri, mat_tri, scene, px, py,
                          cfg.alpha_peels, cfg.alpha_clip)
    return az, aid, oy, ox


def alpha_apply_punch(shadow_map, az, aid, oy, ox):
    """Min-merge one cascade's punch window into its (S, S) shadow map."""
    Wn = az.shape[0]
    window = jax.lax.dynamic_slice(shadow_map, (oy, ox), (Wn, Wn))
    merged = jnp.where(aid >= 0, jnp.minimum(window, az), window)
    return jax.lax.dynamic_update_slice(shadow_map, merged, (oy, ox))


def alpha_merge_shadow(scene: DeviceScene, consts: FrameConstants,
                       cfg: RenderConfig, shadow_maps):
    """Punch the AlphaTested casters into the cascade shadow maps
    (Shadows.hlsl ALPHA_TEST PS, :49-65): per cascade, depth-peel the AT
    triangles inside a statically-sized window positioned over the
    layer's light-space bounding box and min-merge passing fragments."""
    tri_world, uv_tri, mat_tri = alpha_shadow_geom(scene, consts)
    out = []
    for c in range(shadow_maps.shape[0]):
        az, aid, oy, ox = alpha_punch_window(
            scene, cfg, tri_world, uv_tri, mat_tri,
            consts.cascade_view_projs[c])
        out.append(alpha_apply_punch(shadow_maps[c], az, aid, oy, ox))
    return jnp.stack(out)


def capacity_requirements(scene: DeviceScene, consts: FrameConstants,
                          cfg: RenderConfig):
    """Exact (tile, triangle) pair counts the frame will expand to — the
    quantities pair_capacity/shadow_pair_capacity must exceed, else the
    rasterizer silently drops geometry. Cheap (dense per-triangle math,
    no pair expansion); jit and read two scalars."""
    def tile_counts(tx0, ty0, bw, bh, ntx, nty):
        # exact per-tile counts without pair expansion: rectangle scatter
        # by inclusion-exclusion + 2D cumsum (the XLA path truncates each
        # tile's run at bin_cap, so the max matters)
        img = jnp.zeros((nty + 1, ntx + 1), jnp.int32)
        one = (bw > 0).astype(jnp.int32)
        img = img.at[ty0, tx0].add(one, mode="drop")
        img = img.at[ty0, tx0 + bw].add(-one, mode="drop")
        img = img.at[ty0 + bh, tx0].add(-one, mode="drop")
        img = img.at[ty0 + bh, tx0 + bw].add(one, mode="drop")
        return jnp.cumsum(jnp.cumsum(img, axis=0), axis=1)[:nty, :ntx]

    def max_tile_count(tx0, ty0, bw, bh, ntx, nty):
        return tile_counts(tx0, ty0, bw, bh, ntx, nty).max()

    tris, _ = main_view_tris(scene, consts, cfg)
    tile = raster_tile(cfg)
    tx0, ty0, bw, bh, ntx, nty = rz._tile_bbox(tris, cfg.width, cfg.height,
                                               *tile)
    main_pairs = (bw * bh).astype(jnp.int32).sum()
    main_max_tile = max_tile_count(tx0, ty0, bw, bh, ntx, nty)
    # occupied-SHADE-tile upper bound (tiles any visible triangle's bbox
    # touches >= tiles with covered pixels): sizes shade_tile_capacity
    if tile == (SHADE_TILE_H, SHADE_TILE_W):
        shade_occ = tile_counts(tx0, ty0, bw, bh, ntx, nty) > 0
    else:
        sb = rz._tile_bbox(tris, cfg.width, cfg.height, SHADE_TILE_H,
                           SHADE_TILE_W)
        shade_occ = tile_counts(*sb) > 0
    a_tris = None
    if cfg.alpha_test_enabled and scene.alpha is not None:
        # alpha_merge_main can set tid >= 0 in tiles no OPAQUE bbox
        # touches (fence over sky), so the AT layer's bboxes must count
        # toward shade-tile occupancy or the compacted resolve could
        # clear-fill covered alpha pixels without tripping the guard
        a_tris, _ = alpha_view_tris(scene, consts, cfg)
        ab = rz._tile_bbox(a_tris, cfg.width, cfg.height, SHADE_TILE_H,
                           SHADE_TILE_W)
        shade_occ = shade_occ | (tile_counts(*ab) > 0)
    shade_tiles = shade_occ.sum()

    # occupied-SSAO-tile bound (the compacted occlusion's tile grid is
    # (8, 32) HALF-res pixels = (8k, 32k) full-res; bbox occupancy is
    # a superset of coverage, dilated like the frame's occupancy)
    ssao_tiles = jnp.int32(0)
    if cfg.ssao_enabled:
        kk = cfg.ssao_scale
        sob = rz._tile_bbox(tris, cfg.width, cfg.height,
                            SSAO_TILE_H * kk, SSAO_TILE_W * kk)
        socc = tile_counts(*sob) > 0
        if a_tris is not None:
            sab = rz._tile_bbox(a_tris, cfg.width, cfg.height,
                                SSAO_TILE_H * kk, SSAO_TILE_W * kk)
            socc = socc | (tile_counts(*sab) > 0)
        dy, dx = _SSAO_DILATE_TILES
        sp = jnp.pad(socc, ((dy, dy), (dx, dx)))
        sdil = jnp.zeros_like(socc)
        for oy in range(2 * dy + 1):
            for ox in range(2 * dx + 1):
                sdil = sdil | sp[oy:oy + socc.shape[0],
                                 ox:ox + socc.shape[1]]
        ssao_tiles = sdil.sum()

    S = cfg.shadow_map_size
    C = cfg.num_cascades
    shadow_pairs = jnp.int32(0)
    shadow_max_tile = jnp.int32(0)
    # no shadow pass -> no shadow raster to overflow; skip the 4-cascade
    # setup entirely (it would be dead per-frame work in the viewer's
    # jitted step and could raise a spurious overflow for a pass that
    # never runs)
    if cfg.shadows_enabled:
        tri_world = shadow_tri_world(scene.shadow,
                                     consts.shadow_visibility)
        sh_tile = raster_tile(cfg)
        for c in range(C):
            t = rz.setup_tri_verts(
                shading.rowmat(tri_world, consts.cascade_view_projs[c]),
                                   None, S, S)
            tx0, ty0, bw, bh, ntx, nty = rz._tile_bbox(t, S, S, *sh_tile)
            shadow_pairs = shadow_pairs + (bw * bh).astype(jnp.int32).sum()
            shadow_max_tile = jnp.maximum(
                shadow_max_tile,
                max_tile_count(tx0, ty0, bw, bh, ntx, nty))
    return dict(main_pairs=main_pairs, shadow_pairs=shadow_pairs,
                main_max_tile=main_max_tile,
                shadow_max_tile=shadow_max_tile,
                shade_tiles=shade_tiles, ssao_tiles=ssao_tiles)


# ---------------------------------------------------------------------------
# Full frame
# ---------------------------------------------------------------------------

def render_frame(scene: DeviceScene, consts: FrameConstants,
                 cfg: RenderConfig) -> jnp.ndarray:
    """One full frame -> (H, W, 4) float32 linear color (see module doc)."""
    H, W = cfg.height, cfg.width

    # vertex stage + near-plane clip + main rasterization (one visibility
    # buffer feeds the normal/depth, G-buffer and lighting passes)
    tris, tri_attr = main_view_tris(scene, consts, cfg)
    if uses_kernel(cfg):
        depth, tid = rp.rasterize_pallas(tris, W, H, cfg.pair_capacity,
                                         interpret=cfg.pallas_interpret)
    else:
        bins = rz.bin_triangles(tris, W, H, cfg.pair_capacity)
        depth, tid = rz.rasterize_binned(tris, bins, W, H, cfg.bin_cap)

    alpha_on = cfg.alpha_test_enabled and scene.alpha is not None
    if alpha_on:
        depth, tid, tris, tri_attr = alpha_merge_main(
            scene, consts, cfg, depth, tid, tris, tri_attr)

    g = resolve_gbuffer(scene, consts, cfg, tris, depth, tid, tri_attr)

    if cfg.shadows_enabled:
        shadow_maps = render_shadow_maps(scene, consts, cfg)
        if alpha_on:
            shadow_maps = alpha_merge_shadow(scene, consts, cfg,
                                             shadow_maps)
    else:
        shadow_maps = jnp.ones((cfg.num_cascades, 2, 2), jnp.float32)

    if cfg.ssao_enabled:
        access_half = ssao_pass(scene, consts, cfg, g["normal_v"], depth,
                                valid=tid >= 0)
        ambient_access = _upsample_bilinear(access_half, H, W)
    else:
        ambient_access = jnp.ones((H, W), jnp.float32)

    img = lighting_pass(scene, consts, cfg, g, shadow_maps, ambient_access,
                        depth)
    return apply_debug_overlay(consts, cfg, img, shadow_maps, g["pos_w"])


def apply_debug_overlay(consts: FrameConstants, cfg: RenderConfig,
                        img: jnp.ndarray, shadow_maps: jnp.ndarray,
                        pos_w: jnp.ndarray, row_offset=0,
                        full_height: int = None) -> jnp.ndarray:
    """Debug-layer overlays on the lit image (shared by the single-chip and
    band-sharded paths; `img`/`pos_w` may be a row band whose global first
    row is `row_offset` of a `full_height`-row screen).

    - ShadowDebug.hlsl quad: the reference's FORWARD branch always draws the
      shadow-map blit quad (CRYCHIC.cpp:406-407, PSO "debug"); replicated
      whenever the forward path has shadow maps to show, or on demand via
      cfg.debug_view == "shadow_cascade3".
    - "cascades": Default.hlsl:152-156 (commented out in the reference)
      colorizes pixels by their selected cascade.
    """
    H, W = img.shape[:2]
    full_h = full_height if full_height is not None else H

    draw_quad = cfg.debug_view == "shadow_cascade3" or (
        not cfg.deferred and cfg.shadows_enabled and cfg.debug_view is None)
    if draw_quad:
        # blit gShadowMap[3] onto the debug quad, which CreateQuad(0,0,1,1,0)
        # places in the bottom-right screen quadrant
        qh, qw = full_h // 2, W // 2
        S = shadow_maps.shape[1]
        gy = jnp.arange(H, dtype=jnp.int32) + jnp.asarray(row_offset,
                                                          jnp.int32)
        qy = gy - (full_h - qh)          # row within the quad (<0 above it)
        ys = jnp.clip(qy, 0, qh - 1) * S // qh
        xs = (jnp.arange(qw) * S // qw)
        blit = shadow_maps[3][ys[:, None], xs[None, :]]  # (H, qw)
        patch = jnp.repeat(blit[..., None], 3, axis=-1)
        patch = jnp.concatenate([patch, jnp.ones_like(patch[..., :1])], -1)
        right = jnp.where((qy >= 0)[:, None, None], patch, img[:, W - qw:])
        img = jnp.concatenate([img[:, :W - qw], right], axis=1)
    elif cfg.debug_view == "cascades":
        from ..models.cascades import CASCADE_RADII

        dist = jnp.sqrt(((consts.eye_pos - pos_w) ** 2).sum(-1))
        past = (dist[..., None] >= jnp.asarray(CASCADE_RADII)).sum(-1)
        colors = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                              [1, 1, 1], [0.3, 0.3, 0.3]], jnp.float32)
        col = colors[jnp.clip(past, 0, 4)]
        img = jnp.concatenate([col, img[..., 3:4]], axis=-1)
    return img
