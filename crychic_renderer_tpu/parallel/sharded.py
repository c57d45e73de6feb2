"""Multi-device frame rendering over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md §2.3) — its only
"parallelism" is the D3D12 hardware's internal SIMD plus 3-deep CPU/GPU
pipelining. The scaling story here is screen-space data parallelism:

- RASTERIZATION is sharded with INTERLEAVED tile-row ownership: device d
  rasterizes tile rows ty with ty %% n_dev == d of both the main view and
  the cascade shadow atlas, with GLOBAL tile anchors (bit-identical fp
  math to the single-chip render) and binning restricted to the owned
  rows via owner-major permuted sort keys (rz.bin_triangles row_stride —
  the owner's runs stay contiguous for the raster kernel). Pair
  counts are heavily SKEWED across contiguous bands (the cascade scene's
  horizon band holds 70-90%% of main-view pairs; one atlas band holds
  ~50%% of shadow pairs), so interleaving is what makes the kernel work
  actually balance to ~1/n_dev. The full (depth, tid) visibility buffer
  and shadow stack are then reassembled everywhere by all_gather +
  transpose (~16 + 33 MB/frame), and each device RESOLVES and
  SHADES only its contiguous pixel band — the pixel-space passes are
  naturally balanced, so contiguous bands remain right for them.
- the per-triangle attribute gather + near-plane clip (and the shadow
  casters' world-space gather) are TRIANGLE-sharded: each device computes
  a 1/n_dev triangle range and one all_gather reassembles tables that are
  bit-identical to the replicated computation.
- SSAO: occlusion is band-local but its projective occluder taps sample
  the ALL-GATHERED full half-res depth map (the taps land anywhere on
  screen — Ssao.hlsl:67-69), and the view-ray/random-texture grids use
  GLOBAL pixel rows. The bilateral blurs then run replicated on the
  all-gathered half-res maps (dense work on ~2 MB instead of a halo
  exchange per blur) and each device slices its band back out, so
  sharded SSAO is bit-identical to the single-chip pass.
- the fast-preset PCF factor (cfg.fast_shadow_factor) is computed on the
  band's half-res rows at GLOBAL phase, all-gathered, and upsampled from
  the full map — the same halo recipe as SSAO, so the preset stays
  band-exact (no seams at band boundaries).
- the AlphaTested shadow punch is distributed cascade-per-device; the
  small punch windows are all-gathered and every device applies all of
  them locally.

Any (height, n_devices) combination works: the screen is padded to
n_dev * band_h rows (band_h = ceil(H/n_dev) aligned to the SSAO grid),
bands render rows of the padded screen with TRUE-height NDC math, and the
pad rows are cropped after the shard_map — 1080 rows shard 8-ways as
8 x 136 with the last 8 rows cropped.

Band sharding pays a replicated per-device base (front end, binning), so
a second REPLICA mesh axis (render_frames_replicated) runs independent
frames in flight data-parallel — zero cross-replica collectives, r-fold
throughput for r frames of latency, the mesh generalization of the
reference's 3-deep FrameResource pipeline (CRYCHIC.cpp:135-146).

Determinism note: visible rows are bit-identical to the single-chip
render (global tile anchors + halo-exact resampling); only reduction-order
fp noise remains.

This module is exercised on a virtual 8-device CPU mesh in tests (both the
XLA rasterizer and the raster kernel in interpreter mode), by
``__graft_entry__.dryrun_multichip`` and on four GPUs by
``chip_smoke.py --multi``. The mesh is a flat device list: on GPUs joined
all to all (NVLink) no device order is closer than another.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..ops import clipping
from ..ops import rasterizer as rz
from ..ops import raster_pallas as rp
from ..ops import shading
from ..ops import shadows
from ..ops import ssao as ssao_ops
from ..passes import frame as fr


def band_height(cfg: RenderConfig, n_dev: int) -> int:
    """Rows per device: ceil(H / n_dev), aligned up so every band starts
    on an SSAO-grid (and fast-preset half-grid) phase boundary."""
    align = 1
    if cfg.ssao_enabled:
        align = cfg.ssao_scale
    if cfg.shadows_enabled and cfg.fast_shadow_factor:
        align = align * 2 // math.gcd(align, 2)
    bh = -(-cfg.height // n_dev)
    return -(-bh // align) * align


def _main_band_cap(cfg: RenderConfig) -> int:
    """Per-device main-view pair capacity (interleaved tile rows balance
    to ~1/n_dev + edge effects). Default is the SAFE full-frame capacity;
    autosize_band_capacities tightens it from exact per-owner counts."""
    return cfg.band_pair_capacity or cfg.pair_capacity


def _shadow_band_cap(cfg: RenderConfig) -> int:
    return cfg.shadow_band_pair_capacity or cfg.shadow_pair_capacity


def autosize_band_capacities(scene: fr.DeviceScene,
                             consts: fr.FrameConstants, cfg: RenderConfig,
                             n_dev: int, headroom: float = 1.5
                             ) -> RenderConfig:
    """Size the per-band binning capacities from the EXACT worst-band pair
    counts of the given frame (band_requirements) with ``headroom``,
    rounded to TRI_BLOCK — the band sort/record build then pays for the
    worst band's real load instead of the full-frame capacity. Like the
    single-chip auto-sizing this reflects the given camera; re-run (or
    check band_requirements) after large camera moves."""
    req = band_requirements(scene, consts, cfg, n_dev)

    def size(needed, full):
        cap = -(-int(int(needed) * headroom) // rp.TRI_BLOCK) \
            * rp.TRI_BLOCK
        return min(max(cap, 1 << 13), full)

    kw = dict(band_pair_capacity=size(req["main_band_pairs"],
                                      cfg.pair_capacity))
    if cfg.shadows_enabled:
        kw["shadow_band_pair_capacity"] = size(
            req["shadow_band_pairs"], cfg.shadow_pair_capacity)
    return dataclasses.replace(cfg, **kw)


def _pad_rows(img: jnp.ndarray, rows: int) -> jnp.ndarray:
    """Pad axis 0 to ``rows`` by repeating the last row (pad content is
    cropped after the shard_map; only the shape must line up)."""
    if img.shape[0] >= rows:
        return img
    pad = jnp.broadcast_to(img[-1:], (rows - img.shape[0],) + img.shape[1:])
    return jnp.concatenate([img, pad], axis=0)


class _Comm:
    """The band pipeline's collective surface: the device's index on the
    mesh axis and all_gather over it."""

    def __init__(self, axis: str, n_dev: int):
        self.axis = axis
        self.n_dev = n_dev

    def index(self):
        return jax.lax.axis_index(self.axis)

    def all_gather(self, x):
        """(…) -> (n_dev, …) stacked over devices."""
        return jax.lax.all_gather(x, self.axis)


def _row_chunk(d, x: jnp.ndarray, k: int, n: int):
    """Rows [d*k, (d+1)*k) of ``x`` padded to n*k rows (pad rows repeat
    row 0 values via zero-index semantics where gathered, and are dropped
    on reassembly)."""
    pad = [(0, n * k - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return jax.lax.dynamic_slice_in_dim(jnp.pad(x, pad), d * k, k, axis=0)


def _band_vertex_records(draw: fr.DeviceDraw, visibility, view_proj,
                         mat_transform, comm: _Comm, d):
    """Vertex-sharded vertex_stage + vertex_records: device d runs the
    per-vertex transforms (the ~4 instance-table row gathers + dense
    math) on a 1/n_dev vertex range and
    one all_gather reassembles the full (V, 16) record table
    bit-identically (every op is per-row)."""
    n = comm.n_dev
    V = draw.positions.shape[0]
    kv = -(-V // n)
    chunk = dataclasses.replace(
        draw,
        positions=_row_chunk(d, draw.positions, kv, n),
        normals=_row_chunk(d, draw.normals, kv, n),
        tangents=_row_chunk(d, draw.tangents, kv, n),
        uvs=_row_chunk(d, draw.uvs, kv, n),
        vertex_instance=_row_chunk(d, draw.vertex_instance, kv, n),
    )
    pos_w, nrm_w, tan_w, uv, clip = fr.vertex_stage(
        chunk, visibility, view_proj, mat_transform)
    part = fr.vertex_records(chunk, pos_w, nrm_w, tan_w, uv, clip)
    return comm.all_gather(part).reshape(n * kv, 16)[:V]


def _chunk_gather_rows(comm: _Comm, d, table: jnp.ndarray,
                       idx: jnp.ndarray):
    """Triangle-sharded row gather: device d gathers rows ``idx[d*k ..
    (d+1)*k)`` from ``table`` and one all_gather reassembles the full
    ``table[idx]``. The per-row gather latency (the expensive part of the
    geometry front end — ~3 rows per triangle) is paid once across the
    mesh instead of replicated per device. Returns (full (N, ...), k)."""
    n = comm.n_dev
    N = idx.shape[0]
    k = -(-N // n)
    idx_p = jnp.pad(idx, [(0, n * k - N)] + [(0, 0)] * (idx.ndim - 1))
    chunk = jax.lax.dynamic_slice_in_dim(idx_p, d * k, k, axis=0)
    part = table[chunk]
    full = comm.all_gather(part).reshape((n * k,) + part.shape[1:])[:N]
    return full, k


def _band_main_view_tris(scene: fr.DeviceScene, consts: fr.FrameConstants,
                         cfg: RenderConfig, comm: _Comm, d):
    """Vertex- and triangle-sharded main-view front end (otherwise
    replicated on every device): the per-vertex stage (sharded by vertex
    ranges — _band_vertex_records), the 3-row-per-triangle attribute
    gather, the near-plane clip AND the per-triangle screen setup are all
    computed for 1/n_dev ranges per device and all_gathered — the
    reassembled tables are bit-identical to the replicated
    fr.main_view_tris (every op is per-row), so every downstream consumer
    (binning, resolve via tid indices) is unchanged."""
    n = comm.n_dev
    if n == 1:
        return fr.main_view_tris(scene, consts, cfg)
    draw = scene.opaque
    T = draw.indices.shape[0] // 3
    k = -(-T // n)
    if draw.tri_rest is not None:
        # statics (fr.draw_with_statics): the chunk's records come from a
        # dense clip FMA over the precomputed corner tables + a tiny vis
        # gather — no vertex_records build, no sharded corner gather, no
        # per-vertex all_gather. Pad rows carry arbitrary values (like the
        # legacy path's index-0 pad gathers) and are killed by valid0.
        poswh_c = _row_chunk(d, draw.tri_posw_h, k, n)
        poswh_c = jnp.concatenate(
            [poswh_c[..., :3], jnp.ones_like(poswh_c[..., :1])], -1)
        clip = shading.rowmat(poswh_c, consts.view_proj)
        vis_c = consts.opaque_visibility[
            _row_chunk(d, draw.tri_instance, k, n)]
        a = jnp.concatenate([clip * vis_c[:, None, None],
                             _row_chunk(d, draw.tri_rest, k, n)], -1)
    else:
        vrec = _band_vertex_records(draw, consts.opaque_visibility,
                                    consts.view_proj, scene.mat_transform,
                                    comm, d)
        chunk = _row_chunk(d, draw.indices.reshape(-1, 3), k, n)
        a = vrec[chunk]  # (k, 3, 16) — the sharded gather
    valid0 = (d * k + jnp.arange(k, dtype=jnp.int32)) < T
    a2, valid = clipping.clip_near(a, valid0)  # (2k, ...): k mains+k extras
    # per-triangle screen setup on the chunk (sharded too, instead of
    # replicated over the full 2T table)
    t_chunk = rz.setup_tri_verts(a2[..., :4], valid,
                                 cfg.width, cfg.height)
    g = comm.all_gather(a2)       # (n, 2k, 3, 16)
    gv = comm.all_gather(t_chunk.valid)  # (n, 2k)
    gxy = comm.all_gather(t_chunk.xy)
    gz = comm.all_gather(t_chunk.z)
    giw = comm.all_gather(t_chunk.inv_w)

    def reasm(x):
        # reassemble the replicated clip_near layout: mains, then extras
        return jnp.concatenate([
            x[:, :k].reshape((n * k,) + x.shape[2:])[:T],
            x[:, k:].reshape((n * k,) + x.shape[2:])[:T]])

    tri_attr = reasm(g)
    tris = rz.ScreenTris(xy=reasm(gxy), z=reasm(gz), inv_w=reasm(giw),
                         valid=reasm(gv))
    return tris, tri_attr


def _band_shadow_tri_world(scene: fr.DeviceScene, visibility,
                           comm: _Comm, d):
    """Vertex- and triangle-sharded shadow_tri_world: the world transform
    runs on a 1/n_dev vertex range per device (one all_gather reassembles
    the (V, 4) table), then the 3-row-per-triangle gather is sharded and
    all_gathered. Bit-identical to fr.shadow_tri_world."""
    if comm.n_dev == 1 or scene.shadow.tri_posw_h is not None:
        # statics: the world transform + corner gather are precomputed,
        # so per frame only the vis multiply remains — cheaper
        # replicated than paying two all_gathers to shard it.
        return fr.shadow_tri_world(scene.shadow, visibility)
    draw = scene.shadow
    n = comm.n_dev
    V = draw.positions.shape[0]
    kv = -(-V // n)
    pos_c = _row_chunk(d, draw.positions, kv, n)
    vi_c = _row_chunk(d, draw.vertex_instance, kv, n)
    W = draw.worlds[vi_c]
    ph = jnp.concatenate([pos_c, jnp.ones_like(pos_c[..., :1])], axis=-1)

    part = shading.rowmat(ph, W) * visibility[vi_c][:, None]
    pos_w = comm.all_gather(part).reshape(n * kv, 4)[:V]
    full, _ = _chunk_gather_rows(comm, d, pos_w,
                                 draw.indices.reshape(-1, 3))
    return full  # (T, 3, 4)


def _band_shadow_atlas_tris(scene: fr.DeviceScene,
                            consts: fr.FrameConstants, cfg: RenderConfig,
                            comm: _Comm, d):
    """Triangle-sharded fr.shadow_atlas_tris: the per-cascade projection,
    screen setup, atlas column shift and depth bias (all per-triangle)
    run on
    the device's 1/n_dev triangle chunk of the sharded world-space table;
    one all_gather reassembles the cascade-major (C*T) atlas layout
    bit-identically."""
    S = cfg.shadow_map_size
    vps = consts.cascade_view_projs
    C = vps.shape[0]
    n = comm.n_dev
    if n == 1:
        return fr.shadow_atlas_tris(scene, consts.shadow_visibility, vps,
                                    cfg)
    tri_world = _band_shadow_tri_world(scene, consts.shadow_visibility,
                                       comm, d)
    T = tri_world.shape[0]
    k = -(-T // n)
    part = _row_chunk(d, tri_world, k, n)  # (k, 3, 4)

    chunks = []
    for c in range(C):
        t = rz.setup_tri_verts(shading.rowmat(part, vps[c]), None, S, S)
        t = t._replace(xy=t.xy + jnp.asarray([c * S, 0.0], jnp.float32))
        chunks.append(fr._shadow_bias(t))
    stk = rz.ScreenTris(*[jnp.stack([getattr(t, f) for t in chunks])
                          for f in rz.ScreenTris._fields])

    def reasm(x):  # (n, C, k, ...) -> (C*T, ...)
        return jnp.concatenate([
            x[:, c].reshape((n * k,) + x.shape[3:])[:T] for c in range(C)])

    tris = rz.ScreenTris(*[reasm(comm.all_gather(getattr(stk, f)))
                           for f in rz.ScreenTris._fields])
    col = jnp.repeat(jnp.arange(C, dtype=jnp.float32), T)
    return tris, (col * S, (col + 1) * S)


def _band_shadow_maps(scene: fr.DeviceScene, consts: fr.FrameConstants,
                      cfg: RenderConfig, comm: _Comm, d,
                      packed: bool = False) -> jnp.ndarray:
    """Shadow maps with INTERLEAVED tile-row ownership: device d
    rasterizes atlas tile rows ty with ty %% n_dev == d (owner-major
    permuted sort keys keep its runs contiguous for the streaming
    kernel), and one all_gather + transpose reassembles the full
    (C, S, S) stack everywhere. Interleaving balances the heavily
    pair-skewed shadow load (~50%% of atlas pairs land in one contiguous
    band) to ~1/n_dev per device.

    ``packed`` (kernel path only): each device quantizes + u16-packs its
    OWN atlas rows before the all_gather, returning (C, S, S/2) u32
    texel-pair rows — half the all-gather bytes and half the reassembly
    transpose, and the superwindow build downstream skips its
    quantize/pack head. Bit-identical PCF: quantization is per-texel, so
    it commutes with the row reassembly, and the single-chip path
    quantizes to the same u16 grid inside superwindow_maps_u16. Callers
    keep f32 when raw depths are still consumed (alpha punch min-merge,
    the shadow debug blit)."""
    C = cfg.num_cascades
    S = cfg.shadow_map_size
    n_dev = comm.n_dev
    cap = _shadow_band_cap(cfg)

    if fr.uses_kernel(cfg):
        tile_h = rp.TILE_H
        nty = -(-S // tile_h)
        rpd = -(-nty // n_dev)
        tris, xrange = _band_shadow_atlas_tris(scene, consts, cfg, comm, d)
        depth, _ = rp.rasterize_pallas(
            tris, C * S, S, cap, with_ids=False,
            interpret=cfg.pallas_interpret, xrange=xrange,
            row_stride=(n_dev, d))
        # depth: (rpd*tile_h, C*S), slot-major stripes
        w = C * S
        if packed:
            depth = shadows.pack_depth_rows_u16(depth)
            w = C * S // 2
        g = comm.all_gather(depth)  # (n_dev, rpd*tile_h, w)
        full = g.reshape(n_dev, rpd, tile_h, w).transpose(
            1, 0, 2, 3).reshape(n_dev * rpd * tile_h, w)[:S]
        cw = w // C
        return jnp.stack([full[:, c * cw:(c + 1) * cw] for c in range(C)])

    # XLA path: per-cascade interleaved renders (the single-chip XLA path
    # renders per cascade, not the atlas — keeping the same viewport keeps
    # the edge-function fp math bit-identical)
    tile_h = rz.TILE_H
    nty = -(-S // tile_h)
    rpd = -(-nty // n_dev)
    tri_world = _band_shadow_tri_world(scene, consts.shadow_visibility,
                                       comm, d)

    parts = []
    for c in range(C):
        t = rz.setup_tri_verts(
            shading.rowmat(tri_world, consts.cascade_view_projs[c]),
            None, S, S)
        t = fr._shadow_bias(t)
        bins = rz.bin_triangles(t, S, S, cap, row_stride=(n_dev, d))
        depth, _ = rz.rasterize_binned(t, bins, S, S,
                                       cfg.shadow_bin_cap, with_ids=False,
                                       row_stride=(n_dev, d))
        parts.append(depth)  # (rpd*tile_h, S)
    stacked = jnp.stack(parts)  # (C, rpd*tile_h, S)
    g = comm.all_gather(stacked)  # (n_dev, C, rpd*tile_h, S)
    return g.reshape(n_dev, C, rpd, tile_h, S).transpose(
        1, 2, 0, 3, 4).reshape(C, n_dev * rpd * tile_h, S)[:, :S]


def _band_alpha_shadow(scene: fr.DeviceScene, consts: fr.FrameConstants,
                       cfg: RenderConfig, shadow_maps, comm: _Comm, d):
    """Distributed AT shadow punch: device d computes the punch window for
    cascades d*k .. d*k+k-1 (k = ceil(C/n_dev)), the small windows are
    all-gathered, and every device min-merges all of them locally —
    identical per-cascade math to the single-chip alpha_merge_shadow."""
    C = shadow_maps.shape[0]
    n_dev = comm.n_dev
    k = -(-C // n_dev)
    tri_world, uv_tri, mat_tri = fr.alpha_shadow_geom(scene, consts)
    azs, aids, oys, oxs = [], [], [], []
    for j in range(k):
        c = (d * k + j) % C
        az, aid, oy, ox = fr.alpha_punch_window(
            scene, cfg, tri_world, uv_tri, mat_tri,
            consts.cascade_view_projs[c])
        azs.append(az)
        aids.append(aid)
        oys.append(oy)
        oxs.append(ox)

    def gather(parts):
        x = jnp.stack(parts)  # (k, ...)
        g = comm.all_gather(x)  # (n_dev, k, ...)
        return g.reshape((n_dev * k,) + x.shape[1:])[:C]

    az, aid, oy, ox = (gather(azs), gather(aids), gather(oys), gather(oxs))
    return jnp.stack([
        fr.alpha_apply_punch(shadow_maps[c], az[c], aid[c], oy[c], ox[c])
        for c in range(C)])


def _band_ssao(scene: fr.DeviceScene, consts: fr.FrameConstants,
               cfg: RenderConfig, normal_v, depth, comm: _Comm,
               d, band_h: int):
    """Band-exact SSAO (see module doc): band-local occlusion with
    all-gathered tap depth, replicated blur, slice own band. The gathered
    maps are sliced to the TRUE ssao height before tap sampling and blur,
    so padded bands (height not divisible by n_dev) stay bit-exact."""
    n_half, d_half = fr.ssao_inputs_half(cfg, normal_v, depth)
    n_dev = comm.n_dev
    bh = band_h // cfg.ssao_scale
    true_h = cfg.ssao_height
    d_half_all = comm.all_gather(d_half).reshape(
        n_dev * bh, d_half.shape[1])
    # the 14 occluder taps sample the FULL-RES depth buffer (Ssao.hlsl:164
    # gsamDepthMap — see ssao_occlusion), and they land anywhere on
    # screen, so the full-res band depths are all-gathered too (the
    # half-res gather above still feeds the blur's edge-stop depths)
    depth_all = comm.all_gather(depth).reshape(
        n_dev * depth.shape[0], depth.shape[1])
    band_field = jax.lax.dynamic_slice_in_dim(
        scene.ssao_random_field, d * bh, bh, axis=0)
    access = ssao_ops.ssao_occlusion(
        n_half, d_half, consts.proj, consts.inv_proj,
        scene.ssao_offsets, random_field=band_field,
        tap_depth=depth_all[:cfg.height], row_offset=d * bh,
        full_height=true_h)
    # blur on a band SLICE of the gathered half-res maps with an exact
    # halo: ssao_blur_count iterations of the radius-r vertical blur
    # influence <= count*r rows, so with a (count*r + 1)-row halo every
    # band row's blur — and the rows the final upsample interpolates
    # across — sees exactly the neighbors the full-map (single-chip) blur
    # sees, at ~1/n_dev the replicated-blur cost. Slices clamp to the
    # map, so the first/last bands keep the true edge-clamp semantics.
    radius = (scene.ssao_blur_weights.shape[0] - 1) // 2
    halo = cfg.ssao_blur_count * radius + 1
    access_full = comm.all_gather(access).reshape(
        n_dev * bh, access.shape[1])[:true_h]
    n_half_full = comm.all_gather(n_half).reshape(
        n_dev * bh, *n_half.shape[1:])[:true_h]
    win = min(bh + 2 * halo, true_h)
    lo = jnp.clip(d * bh - halo, 0, true_h - win)

    def sl(x):
        return jax.lax.dynamic_slice_in_dim(x, lo, win, axis=0)

    blurred = fr.ssao_blur(scene, consts, cfg, sl(access_full),
                           sl(n_half_full), sl(d_half_all[:true_h]))
    # scatter the blurred band back into the full map (the rest of the
    # rows only matter through the upsample's halo: rows within the
    # bilinear support of the band boundary are inside the exact-halo
    # window, so the final band slice matches single-chip exactly)
    access_full = jax.lax.dynamic_update_slice_in_dim(
        access_full, blurred, lo, axis=0)
    up = fr._upsample_bilinear(access_full, cfg.height, cfg.width)
    up = _pad_rows(up, band_h * n_dev)
    return jax.lax.dynamic_slice_in_dim(up, d * band_h, band_h, axis=0)


def _band_fast_shadow_factor(scene: fr.DeviceScene,
                             consts: fr.FrameConstants, cfg: RenderConfig,
                             pos_w, valid, shadow_maps, comm: _Comm,
                             d, band_h: int):
    """Band-exact fast-preset PCF: evaluate the half-res factor on the
    band's GLOBAL-phase rows (band_h is even by construction), all_gather,
    upsample the full map, slice the band — same halo recipe as SSAO."""
    sf_local = shadows.cascade_shadow_factor(
        shadow_maps, consts.shadow_transforms, pos_w[::2, ::2],
        consts.eye_pos, cfg.shadow_map_size,
        deferred_blend_quirk=cfg.deferred,
        soft_radius_texels=cfg.pcf_radius_texels,
        dead=~valid[::2, ::2])
    n_dev = comm.n_dev
    bh2 = band_h // 2
    sf_all = comm.all_gather(sf_local).reshape(
        n_dev * bh2, sf_local.shape[1])
    true_h2 = (cfg.height + 1) // 2
    sf_full = fr._upsample_bilinear(sf_all[:true_h2], cfg.height, cfg.width)
    sf_full = _pad_rows(sf_full, band_h * n_dev)
    return jax.lax.dynamic_slice_in_dim(sf_full, d * band_h, band_h, axis=0)


def _band_render(scene: fr.DeviceScene, consts: fr.FrameConstants,
                 cfg: RenderConfig, comm: _Comm, band_h: int):
    """Per-device body: render this device's pixel band (full pipeline).
    The band covers rows [d*band_h, (d+1)*band_h) of an n_dev*band_h-row
    PADDED screen; all NDC/viewport math uses the TRUE cfg.height, so pad
    rows (>= cfg.height) hold don't-care values cropped by the caller."""
    d = comm.index()
    n_dev = comm.n_dev
    H, W = cfg.height, cfg.width
    H_pad = band_h * n_dev

    alpha_on = cfg.alpha_test_enabled and scene.alpha is not None
    if cfg.shadows_enabled:
        # ship the atlas as u16 texel-pairs when nothing downstream needs
        # f32 depths (see _band_shadow_maps); f32 is kept when the alpha
        # punch must min-merge into the maps or the debug quad blits them
        quad = cfg.debug_view == "shadow_cascade3" or (
            not cfg.deferred and cfg.debug_view is None)
        packed = fr.uses_kernel(cfg) and not alpha_on and not quad
        shadow_maps = _band_shadow_maps(scene, consts, cfg, comm, d,
                                        packed=packed)
    else:
        shadow_maps = jnp.ones((cfg.num_cascades, 2, 2), jnp.float32)

    # ---- main visibility buffer: INTERLEAVED tile-row ownership (the
    # horizon band holds 70-90% of the frame's pairs, so contiguous-band
    # raster ownership left the worst device with near-full-frame kernel
    # work); every device rasterizes its strided tile rows with GLOBAL
    # anchors (bit-identical), the full (depth, tid) buffer is
    # all_gathered (~16 MB/frame), and each device resolves/shades only
    # its contiguous pixel band as before.
    tris, tri_attr = _band_main_view_tris(scene, consts, cfg, comm, d)
    y0 = d * band_h  # first band pixel row (traced)
    tile_h, _ = fr.raster_tile(cfg)
    nty = -(-H_pad // tile_h)
    rpd = -(-nty // n_dev)
    # bands keep the full-screen resolve: each band's tile occupancy is
    # pose-dependent per device, and the band split already divides the
    # gather rows n_dev ways (tile compaction composes later if needed)
    band_cfg = dataclasses.replace(cfg, height=band_h,
                                   shade_tile_capacity=None)
    cap = _main_band_cap(cfg)
    if fr.uses_kernel(cfg):
        dpart, tpart = rp.rasterize_pallas(tris, W, H_pad, cap,
                                           interpret=cfg.pallas_interpret,
                                           row_stride=(n_dev, d))
    else:
        bins = rz.bin_triangles(tris, W, H_pad, cap,
                                row_stride=(n_dev, d))
        dpart, tpart = rz.rasterize_binned(tris, bins, W, H_pad,
                                           cfg.bin_cap,
                                           row_stride=(n_dev, d))

    def reassemble(part):
        g = comm.all_gather(part)  # (n_dev, rpd*tile_h, W)
        return g.reshape(n_dev, rpd, tile_h, W).transpose(
            1, 0, 2, 3).reshape(n_dev * rpd * tile_h, W)

    depth_full = reassemble(dpart)
    tid_full = reassemble(tpart)
    # slice the band + 1 halo row below it (uv derivatives at the seam);
    # the buffer is extended by one duplicate row so the last band's
    # slice stays in range (its halo contribution is overridden by
    # resolve_gbuffer's last-image-row derivative rule)
    depth_full = jnp.concatenate([depth_full, depth_full[-1:]], axis=0)
    tid_full = jnp.concatenate([tid_full, tid_full[-1:]], axis=0)
    depth = jax.lax.dynamic_slice_in_dim(depth_full, y0, band_h + 1,
                                         axis=0)
    tid = jax.lax.dynamic_slice_in_dim(tid_full, y0, band_h + 1, axis=0)

    if alpha_on:
        # AlphaTested layer: dense peel over the band's GLOBAL pixel rows
        # (+ the halo row) — same math as the single-chip merge, so band
        # output stays bit-identical
        depth, tid, tris, tri_attr = fr.alpha_merge_main(
            scene, consts, cfg, depth, tid, tris, tri_attr,
            row_offset=y0.astype(jnp.float32))
        if cfg.shadows_enabled:
            shadow_maps = _band_alpha_shadow(scene, consts, cfg,
                                             shadow_maps, comm, d)

    g = fr.resolve_gbuffer(scene, consts, band_cfg, tris, depth, tid,
                           tri_attr, row_offset=y0, full_height=H,
                           out_rows=band_h)
    depth = depth[:band_h]

    if cfg.ssao_enabled:
        ambient_access = _band_ssao(scene, consts, cfg, g["normal_v"],
                                    depth, comm, d, band_h)
    else:
        ambient_access = jnp.ones((band_h, W), jnp.float32)

    sf = None
    if cfg.shadows_enabled and cfg.fast_shadow_factor:
        sf = _band_fast_shadow_factor(scene, consts, cfg, g["pos_w"],
                                      g["valid"], shadow_maps, comm, d,
                                      band_h)

    img = fr.lighting_pass(scene, consts, band_cfg, g, shadow_maps,
                           ambient_access, depth,
                           row_offset=(d * band_h).astype(jnp.float32),
                           full_height=H, shadow_factor=sf)
    # debug layers (forward-branch shadow quad / cascade colorization) at
    # global row phase — keeps forward+shadows configs band-exact too
    return fr.apply_debug_overlay(consts, cfg, img, shadow_maps,
                                  g["pos_w"], row_offset=y0, full_height=H)


def render_frame_sharded(scene: fr.DeviceScene, consts: fr.FrameConstants,
                         cfg: RenderConfig, mesh: Mesh,
                         axis: str = "sp") -> jnp.ndarray:
    """Full frame over an n-device mesh; returns (H, W, 4) sharded by rows.

    Works for ANY (height, n_devices): bands are padded to an aligned
    height and the pad rows cropped (see module doc)."""
    n_dev = mesh.shape[axis]
    band_h = band_height(cfg, n_dev)
    H_pad = band_h * n_dev
    if cfg.ssao_enabled:
        # padded bands index SSAO random-field rows past the true height;
        # extend the (frame-constant) field with don't-care edge rows
        need = H_pad // cfg.ssao_scale
        field = scene.ssao_random_field
        if field.shape[0] < need:
            scene = dataclasses.replace(
                scene, ssao_random_field=_pad_rows(field, need))

    fn = shard_map(
        functools.partial(_band_render, cfg=cfg,
                          comm=_Comm(axis, n_dev), band_h=band_h),
        mesh=mesh,
        in_specs=(P(), P()),  # scene + consts replicated
        out_specs=P(axis),  # image sharded by rows
        # the per-band scan carries start replicated and become varying
        # (band depends on axis_index); skip the vma check
        check_vma=False,
    )
    img = fn(scene, consts)
    return img[:cfg.height] if H_pad != cfg.height else img


def band_requirements(scene: fr.DeviceScene, consts: fr.FrameConstants,
                      cfg: RenderConfig, n_dev: int) -> dict:
    """Exact worst-DEVICE (tile, triangle) pair counts for the sharded
    frame's interleaved binning (tile rows ty %% n_dev == d) — what the
    per-band capacities must exceed, else a device silently drops
    geometry. Dense per-triangle math (no pair expansion); jittable."""
    band_h = band_height(cfg, n_dev)
    H_pad = band_h * n_dev

    def worst_owner(tris, width, bin_h, tile):
        tx0, ty0, bw, bh, ntx, nty = rz._tile_bbox(tris, width, bin_h,
                                                   *tile)
        rows = jnp.zeros(nty + 1, jnp.int32)
        rows = rows.at[ty0].add(bw * (bh > 0), mode="drop")
        rows = rows.at[ty0 + bh].add(-bw * (bh > 0), mode="drop")
        # pairs per tile row = sum over triangles overlapping that row of
        # their bbox width; difference-array scatter + cumsum gives it
        per_row = jnp.cumsum(rows[:nty])
        rpd = -(-nty // n_dev)
        per_row = jnp.pad(per_row, (0, rpd * n_dev - nty))
        # owner d's total = sum of rows ty with ty %% n_dev == d
        return per_row.reshape(rpd, n_dev).sum(axis=0).max()

    out = {"band_h": band_h}
    tris, _ = fr.main_view_tris(scene, consts, cfg)
    out["main_band_pairs"] = worst_owner(tris, cfg.width, H_pad,
                                         fr.raster_tile(cfg))
    out["main_band_capacity"] = _main_band_cap(cfg)

    if cfg.shadows_enabled:
        S = cfg.shadow_map_size
        C = cfg.num_cascades
        tile_s = fr.raster_tile(cfg)
        if fr.uses_kernel(cfg):
            s_tris, _ = fr.shadow_atlas_tris(
                scene, consts.shadow_visibility,
                consts.cascade_view_projs, cfg)
            worst = worst_owner(s_tris, C * S, S, tile_s)
        else:

            tri_world = fr.shadow_tri_world(scene.shadow,
                                            consts.shadow_visibility)
            worst = jnp.int32(0)
            for c in range(C):
                t = rz.setup_tri_verts(
                    shading.rowmat(tri_world, consts.cascade_view_projs[c]),
                    None, S, S)
                worst = jnp.maximum(worst,
                                    worst_owner(t, S, S, tile_s))
        out["shadow_band_pairs"] = worst
        out["shadow_band_capacity"] = _shadow_band_cap(cfg)
    return out


def check_band_capacity(scene: fr.DeviceScene, consts: fr.FrameConstants,
                        cfg: RenderConfig, n_dev: int) -> dict:
    """Raise if THIS frame would overflow the sized per-band capacities —
    the sharded-path mirror of Renderer.check_capacity (the band binning
    truncates at band_pair_capacity and silently drops geometry past it).
    Call per frame in a live loop (or after large camera moves when the
    capacities came from autosize_band_capacities at an earlier camera).
    Returns the band_requirements dict for logging."""
    req = {k: (int(v) if not isinstance(v, int) else v)
           for k, v in band_requirements(scene, consts, cfg, n_dev).items()}
    if req["main_band_pairs"] > req["main_band_capacity"]:
        raise RuntimeError(
            f"sharded main raster overflow: worst device needs "
            f"{req['main_band_pairs']} pairs > band capacity "
            f"{req['main_band_capacity']}; re-run autosize_band_capacities")
    if cfg.shadows_enabled and (req["shadow_band_pairs"]
                                > req["shadow_band_capacity"]):
        raise RuntimeError(
            f"sharded shadow raster overflow: worst device needs "
            f"{req['shadow_band_pairs']} pairs > band capacity "
            f"{req['shadow_band_capacity']}; re-run "
            f"autosize_band_capacities")
    return req


def make_mesh(n_devices: int = None, axis: str = "sp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


# ---------------------------------------------------------------------------
# Replica axis: data-parallel frames in flight
# ---------------------------------------------------------------------------

def make_mesh2(n_rep: int, n_band: int, rep_axis: str = "rep",
               band_axis: str = "sp") -> Mesh:
    """A 2D (replica, band) mesh over the first n_rep*n_band devices.
    Replica groups are laid out along the SLOW mesh dim so each group's
    band all_gathers stay within a contiguous device block; there is no
    cross-replica communication at all."""
    devs = jax.devices()[: n_rep * n_band]
    return Mesh(np.array(devs).reshape(n_rep, n_band),
                (rep_axis, band_axis))


def stack_frames(pytrees):
    """Stack per-frame pytrees (DeviceScene or FrameConstants) along a new
    leading replica axis — the input format of render_frames_replicated.
    Frames in flight differ only in small leaves (frame constants, the
    animated mat_pair table); the big scene arrays are identical and XLA
    deduplicates the broadcast on device."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *pytrees)


def render_frames_replicated(scenes, consts, cfg: RenderConfig, mesh: Mesh,
                             rep_axis: str = "rep",
                             band_axis: str = "sp") -> jnp.ndarray:
    """n_rep independent frames, each band-sharded n_band ways, in ONE
    dispatch over a 2D (replica, band) mesh. Returns (n_rep, H, W, 4).

    Band sharding alone flattens on its replicated per-device base;
    frames in flight are INDEPENDENT, so the replica axis multiplies
    throughput with zero cross-replica collectives — the mesh
    generalization of the reference's own
    3-deep FrameResource pipeline (/root/reference/CRYCHIC.h:20
    gNumFrameResources=3, CRYCHIC.cpp:135-146): replica r renders frame
    i+r while the host prepares the next batch, trading r frames of
    latency for r-fold throughput exactly like the reference trades 3.

    scenes/consts: pytrees stacked along a leading n_rep axis
    (stack_frames). All _Comm collectives inside _band_render name only
    the band axis, so shard_map scopes them to each replica group.
    """
    n_rep = mesh.shape[rep_axis]
    n_dev = mesh.shape[band_axis]
    band_h = band_height(cfg, n_dev)
    H_pad = band_h * n_dev
    if cfg.ssao_enabled:
        need = H_pad // cfg.ssao_scale
        field = scenes.ssao_random_field  # (n_rep, rows, ...)
        if field.shape[1] < need:
            pad = jnp.repeat(field[:, -1:], need - field.shape[1], axis=1)
            scenes = dataclasses.replace(
                scenes, ssao_random_field=jnp.concatenate([field, pad], 1))

    def body(scene_s, consts_s):
        scene1 = jax.tree.map(lambda x: x[0], scene_s)
        consts1 = jax.tree.map(lambda x: x[0], consts_s)
        img = _band_render(scene1, consts1, cfg,
                           _Comm(band_axis, n_dev), band_h)
        return img[None]

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(rep_axis), P(rep_axis)),
        out_specs=P(rep_axis, band_axis),
        check_vma=False,
    )
    imgs = fn(scenes, consts)
    return imgs[:, :cfg.height] if H_pad != cfg.height else imgs
