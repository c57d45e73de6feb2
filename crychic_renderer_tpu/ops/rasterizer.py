"""Tile-based visibility-buffer rasterizer.

This module replaces the D3D12 rasterization hardware the reference gets
for free from ``DrawIndexedInstanced`` (/root/reference/CRYCHIC.cpp:2473):
vertex transform happens upstream as batched matrix products; here we bin
screen-space triangles to pixel tiles and run a coverage + depth test per
tile, producing a *visibility buffer* (per-pixel depth + winning triangle
id). Attribute interpolation and shading happen in later passes by
gathering the winning triangle's vertex data — a split that keeps
rasterization dense and pays exactly one gather per pixel for
attributes.

D3D11/12 rasterization rules replicated:
- viewport transform ``x = (ndc.x*0.5+0.5)*W``, ``y = (0.5-ndc.y*0.5)*H``,
  pixel centers at integer+0.5, NDC z in [0,1];
- front faces are clockwise in screen space (y down); back faces culled;
- top-left fill convention on shared edges;
- depth is interpolated linearly in screen space (z/w is affine), depth
  test LESS, depth cleared to 1.0.

Binning is exact and fully static-shaped: per-triangle tile-bbox counts
-> exclusive cumsum -> fixed-capacity pair expansion via searchsorted ->
sort pairs by tile -> contiguous per-tile runs (start, count). The same
binning feeds both the pure-XLA rasterizer here (the plain reference, and
the CPU path) and the GPU kernel in ``raster_pallas.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Tile size of this XLA reference path (the kernel in raster_pallas.py
# bins at its own tile).
TILE_H = 32
TILE_W = 128


class ScreenTris(NamedTuple):
    """Screen-space triangle setup (one record per triangle)."""

    xy: jnp.ndarray  # (T, 3, 2) screen coords
    z: jnp.ndarray  # (T, 3) NDC z at each vertex
    inv_w: jnp.ndarray  # (T, 3) 1/clip.w (for perspective-correct interp)
    valid: jnp.ndarray  # (T,) bool (in front of near plane, front-facing)


class Bins(NamedTuple):
    order: jnp.ndarray  # (P,) int32 pair -> triangle id (sorted by tile)
    starts: jnp.ndarray  # (num_tiles,) int32 first pair of each tile
    counts: jnp.ndarray  # (num_tiles,) int32 pairs per tile
    sorted_tile: jnp.ndarray  # (P,) int32 tile id per sorted pair
    num_valid: jnp.ndarray  # () int32 total valid pairs
    overflowed: jnp.ndarray  # () bool — pair capacity exceeded


def viewport_transform(clip: jnp.ndarray, width: int, height: int) -> tuple:
    """clip: (..., 4) row-vector clip-space positions -> screen xy, z, 1/w.

    Returns (xy(..., 2), z(...,), inv_w(...,), in_front(...,) bool).
    """
    w = clip[..., 3]
    in_front = w > 1e-6
    safe_w = jnp.where(in_front, w, 1.0)
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return jnp.stack([sx, sy], axis=-1), ndc[..., 2], inv_w, in_front


def setup_triangles(clip_verts: jnp.ndarray, indices: jnp.ndarray,
                    width: int, height: int,
                    cull_backface: bool = True) -> ScreenTris:
    """clip_verts: (V, 4); indices: (T*3,) -> per-triangle screen setup.

    Triangles with any vertex behind the near plane are culled; callers
    needing correct behavior at the near plane clip first (ops.clipping)
    and use setup_tri_verts.
    """
    tri_idx = indices.reshape(-1, 3)
    v = clip_verts[tri_idx]  # (T, 3, 4)
    return setup_tri_verts(v, None, width, height, cull_backface)


SUBPIXEL = 256.0  # 1/256-pixel snapping (the D3D subpixel grid)


def snap_xy(xy: jnp.ndarray) -> jnp.ndarray:
    return jnp.round(xy * SUBPIXEL) / SUBPIXEL


def setup_tri_verts(v: jnp.ndarray, valid_in, width: int, height: int,
                    cull_backface: bool = True) -> ScreenTris:
    """Per-triangle screen setup from explicit clip-space vertices
    (T, 3, 4) — the entry point for pre-clipped geometry.

    Vertex xy snaps to the 1/256 subpixel grid HERE so every rasterization
    path (bruteforce, binned XLA, raster kernel, bands, capacity probes)
    bins and tests the same coordinates — kernel-vs-XLA winners then
    agree except at true shared-edge ties."""
    xy, z, inv_w, in_front = viewport_transform(v, width, height)
    xy = snap_xy(xy)
    valid = in_front.all(axis=-1)
    if valid_in is not None:
        valid = valid & valid_in

    # signed doubled area in y-down screen space; front (CW) => positive
    x0, y0 = xy[:, 0, 0], xy[:, 0, 1]
    x1, y1 = xy[:, 1, 0], xy[:, 1, 1]
    x2, y2 = xy[:, 2, 0], xy[:, 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    if cull_backface:
        valid = valid & (area2 > 0.0)
    else:
        # flip winding of back faces so edge tests stay consistent
        flip = area2 < 0.0
        xy = jnp.where(flip[:, None, None], xy[:, ::-1, :], xy)
        z = jnp.where(flip[:, None], z[:, ::-1], z)
        inv_w = jnp.where(flip[:, None], inv_w[:, ::-1], inv_w)
        valid = valid & (area2 != 0.0)
    return ScreenTris(xy=xy, z=z, inv_w=inv_w, valid=valid)


def _tile_bbox(tris: ScreenTris, width: int, height: int,
               tile_h: int, tile_w: int):
    """Per-triangle inclusive tile bbox (tx0, ty0, bw, bh); bw/bh==0 if culled."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    xmin = tris.xy[..., 0].min(axis=-1)
    xmax = tris.xy[..., 0].max(axis=-1)
    ymin = tris.xy[..., 1].min(axis=-1)
    ymax = tris.xy[..., 1].max(axis=-1)
    # pixel centers are at +0.5: a triangle covers pixel columns
    # ceil(xmin-0.5)..floor(xmax-0.5); conservative tile bounds below.
    tx0 = jnp.clip(jnp.floor(xmin / tile_w).astype(jnp.int32), 0, ntx - 1)
    tx1 = jnp.clip(jnp.floor((xmax - 1e-6) / tile_w).astype(jnp.int32), 0, ntx - 1)
    ty0 = jnp.clip(jnp.floor(ymin / tile_h).astype(jnp.int32), 0, nty - 1)
    ty1 = jnp.clip(jnp.floor((ymax - 1e-6) / tile_h).astype(jnp.int32), 0, nty - 1)
    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    # subpixel cull: a triangle whose bbox straddles no pixel CENTER can
    # produce no coverage. Far shadow cascades shrink whole meshes to a few
    # texels — without this, tens of thousands of zero-coverage triangles
    # pile into single tiles of the atlas. The 1/256
    # margin keeps the test conservative under the kernel's subpixel snap.
    eps = 1.0 / 256.0
    no_center = (jnp.floor(xmax - 0.5 + eps) < jnp.ceil(xmin - 0.5 - eps)) \
        | (jnp.floor(ymax - 0.5 + eps) < jnp.ceil(ymin - 0.5 - eps))
    keep = tris.valid & ~offscreen & ~no_center
    bw = jnp.where(keep, tx1 - tx0 + 1, 0)
    bh = jnp.where(keep, ty1 - ty0 + 1, 0)
    return tx0, ty0, bw, bh, ntx, nty


def bin_triangles(tris: ScreenTris, width: int, height: int,
                  pair_capacity: int, tile_h: int = None,
                  tile_w: int = None, ty_lo=None,
                  num_rows: int = None, row_stride=None) -> Bins:
    """Exact tile binning with static shapes.

    Expands each triangle into (tile, tri) pairs via an exclusive-cumsum +
    searchsorted trick (no per-triangle loop, no per-triangle cap), sorts
    pairs by tile id, and returns per-tile contiguous runs.

    Contiguous-band restriction (``ty_lo`` traced scalar ok + ``num_rows``
    static): only pairs whose tile row falls in [ty_lo, ty_lo + num_rows)
    are expanded. Tile ids stay GLOBAL, and each in-band tile's run holds
    the same triangles in the same order as the full binning, so band
    rasterization is bit-identical. NOTE: the production multi-chip path
    (parallel.sharded) uses the INTERLEAVED mode below instead (contiguous
    bands left the horizon-band device with 70-90% of the pairs); this
    mode is kept for the exactness tests and single-band probes.

    Interleaved restriction (``row_stride=(n_dev, owner)``, owner traced
    ok): only tile rows ty with ty % n_dev == owner are expanded — pair
    counts are heavily SKEWED across contiguous bands (a horizon band can
    hold 70-90% of a frame's pairs), and strided ownership balances them
    to ~1/n_dev per device. Pairs are sorted by an OWNER-MAJOR permuted
    key, key = (owner * rows_per_dev + ty // n_dev) * ntx + tx, so the
    owner's tiles form one contiguous run range [owner * rows_per_dev *
    ntx, ...) — the streaming kernel's contiguity requirement — while
    per-tile run contents and order stay identical to full binning.
    ``starts``/``counts``/``sorted_tile`` are indexed by the PERMUTED key
    (key space size ceil(nty / n_dev) * n_dev * ntx); consumers recover
    the true tile row as (key_row % rows_per_dev) * n_dev + key_row //
    rows_per_dev.
    """
    tile_h = TILE_H if tile_h is None else tile_h
    tile_w = TILE_W if tile_w is None else tile_w
    tx0, ty0, bw, bh, ntx, nty = _tile_bbox(tris, width, height,
                                            tile_h, tile_w)
    if ty_lo is not None:
        lo = jnp.asarray(ty_lo, jnp.int32)
        ty1 = ty0 + bh - 1
        ty0 = jnp.maximum(ty0, lo)
        bh = jnp.clip(jnp.minimum(ty1, lo + num_rows - 1) - ty0 + 1,
                      0, None)
        bw = jnp.where(bh > 0, bw, 0)
        bh = jnp.where(bw > 0, bh, 0)
    if row_stride is not None:
        n_dev, owner = row_stride
        owner = jnp.asarray(owner, jnp.int32)
        rpd = -(-nty // n_dev)
        # owned rows of the bbox: ty0 <= ty <= ty1 with ty % n_dev == owner
        ty1 = ty0 + bh - 1
        first = ty0 + (owner - ty0) % n_dev
        bh = jnp.where(first > ty1, 0, (ty1 - first) // n_dev + 1)
        ty0 = first
        bw = jnp.where(bh > 0, bw, 0)
        bh = jnp.where(bw > 0, bh, 0)
        row_mult = n_dev
        num_keys = rpd * n_dev * ntx
    else:
        row_mult = 1
        num_keys = ntx * nty
    counts = (bw * bh).astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts  # exclusive
    total = offsets[-1] + counts[-1] if counts.shape[0] else jnp.int32(0)

    pair_idx = jnp.arange(pair_capacity, dtype=jnp.int32)
    # tri_of_pair = searchsorted(offsets, pair_idx, 'right') - 1, computed
    # as scatter-add + cumsum (one pass over the pairs instead of a
    # binary search per pair)
    marks = jnp.zeros(pair_capacity, jnp.int32).at[offsets].add(
        1, mode="drop")
    tri_of_pair = jnp.cumsum(marks) - 1
    tri_of_pair = jnp.clip(tri_of_pair, 0, counts.shape[0] - 1)
    # one packed row-gather for the 4 per-tri fields (gather latency is
    # per row, not per element)
    packed = jnp.stack([offsets, bw, tx0, ty0], axis=-1)  # (T, 4)
    pp = packed[tri_of_pair]  # (P, 4)
    slot = pair_idx - pp[:, 0]
    bw_p = jnp.maximum(pp[:, 1], 1)
    ty = pp[:, 3] + (slot // bw_p) * row_mult
    tx = pp[:, 2] + slot % bw_p
    valid_pair = pair_idx < jnp.minimum(total, pair_capacity)
    if row_stride is not None:
        key_row = owner * rpd + ty // n_dev  # ty % n_dev == owner
        tile_id = jnp.where(valid_pair, key_row * ntx + tx, num_keys)
    else:
        tile_id = jnp.where(valid_pair, ty * ntx + tx, num_keys)

    # ONE stable sort carrying tri_of_pair as a value (instead of argsort
    # + two P-row gathers by sort order). Stability keeps
    # each tile run's pair (and hence tri) ids ascending, which the
    # kernel's exact-z tie rule relies on.
    sorted_tile, order = jax.lax.sort(
        (tile_id, tri_of_pair.astype(jnp.int32)), num_keys=1,
        is_stable=True)

    # per-tile (start, count) via histogram + exclusive cumsum
    hist = jnp.zeros(num_keys, jnp.int32).at[tile_id].add(1, mode="drop")
    starts = (jnp.cumsum(hist) - hist).astype(jnp.int32)
    return Bins(order=order, starts=starts, counts=hist,
                sorted_tile=sorted_tile.astype(jnp.int32),
                num_valid=jnp.minimum(total, pair_capacity),
                overflowed=total > pair_capacity)


# ---------------------------------------------------------------------------
# Coverage / depth core (shared math)
# ---------------------------------------------------------------------------

def _edge_coeffs(xy: jnp.ndarray):
    """Edge-function coefficients for the 3 edges of each triangle.

    xy: (T, 3, 2). Edge i runs a=v_{(i+1)%3} -> b=v_{(i+2)%3} and weights
    vertex i. E_i(p) = A_i*px + B_i*py + C_i, interior (front face) > 0.
    Returns A, B, C: (T, 3) and area2: (T,).
    """
    a = xy[:, [1, 2, 0], :]
    b = xy[:, [2, 0, 1], :]
    # edge(a,b,p) = (bx-ax)(py-ay) - (by-ay)(px-ax)
    A = -(b[..., 1] - a[..., 1])
    B = b[..., 0] - a[..., 0]
    C = -(A * a[..., 0] + B * a[..., 1])
    x0, y0 = xy[:, 0, 0], xy[:, 0, 1]
    x1, y1 = xy[:, 1, 0], xy[:, 1, 1]
    x2, y2 = xy[:, 2, 0], xy[:, 2, 1]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    # top-left rule: count E == 0 as inside only for top (dy==0, dx>0)
    # and left (dy<0) edges, in y-down screen space with CW front faces.
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    top_left = (dy < 0) | ((dy == 0) & (dx > 0))
    return A, B, C, area2, top_left


def barycentrics_at(xy: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray):
    """Screen-space barycentric weights of each triangle at points (px, py).

    xy: (..., 3, 2); px/py broadcastable against xy[..., 0, 0].
    Returns (..., 3) weights summing to 1 (unnormalized by w).
    """
    a = xy[..., [1, 2, 0], :]
    b = xy[..., [2, 0, 1], :]
    E = ((b[..., 0] - a[..., 0]) * (py[..., None] - a[..., 1])
         - (b[..., 1] - a[..., 1]) * (px[..., None] - a[..., 0]))
    area2 = E.sum(axis=-1, keepdims=True)
    return E / jnp.where(area2 == 0, 1.0, area2)


def rasterize_bruteforce(tris: ScreenTris, width: int, height: int,
                         tri_block: int = 64):
    """All-triangles-vs-all-pixels reference rasterizer (tests / tiny scenes).

    Returns (depth (H, W) f32 cleared to 1.0, tri_id (H, W) i32, -1 = none).
    """
    A, B, C, area2, top_left = _edge_coeffs(tris.xy)
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]

    T = tris.xy.shape[0]
    pad = (-T) % tri_block
    def padt(x, fill=0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    A_, B_, C_ = padt(A), padt(B), padt(C)
    z_ = padt(tris.z)
    area2_ = padt(area2, 1.0)
    tl_ = padt(top_left)
    valid_ = padt(tris.valid, False)
    nblk = (T + pad) // tri_block

    def body(carry, blk):
        depth, tid = carry
        (Ab, Bb, Cb, zb, a2b, tlb, vb, base) = blk
        # E: (TB, 3, H, W)
        E = (Ab[:, :, None, None] * px[None, None]
             + Bb[:, :, None, None] * py[None, None]
             + Cb[:, :, None, None])
        inside = (E > 0) | ((E == 0) & tlb[:, :, None, None])
        cov = inside.all(axis=1) & vb[:, None, None]
        zpix = (E * zb[:, :, None, None]).sum(axis=1) / a2b[:, None, None]
        zpix = jnp.where(cov & (zpix >= 0.0) & (zpix <= 1.0), zpix, jnp.inf)
        zmin = zpix.min(axis=0)
        amin = jnp.argmin(zpix, axis=0).astype(jnp.int32)
        better = zmin < depth
        depth = jnp.where(better, zmin, depth)
        tid = jnp.where(better, base + amin, tid)
        return (depth, tid), None

    depth0 = jnp.full((height, width), 1.0, dtype=jnp.float32)
    tid0 = jnp.full((height, width), -1, dtype=jnp.int32)
    blocks = (
        A_.reshape(nblk, tri_block, 3),
        B_.reshape(nblk, tri_block, 3),
        C_.reshape(nblk, tri_block, 3),
        z_.reshape(nblk, tri_block, 3),
        area2_.reshape(nblk, tri_block),
        tl_.reshape(nblk, tri_block, 3),
        valid_.reshape(nblk, tri_block),
        jnp.arange(nblk, dtype=jnp.int32) * tri_block,
    )
    (depth, tid), _ = jax.lax.scan(body, (depth0, tid0), blocks)
    return depth, tid


def rasterize_binned(tris: ScreenTris, bins: Bins, width: int, height: int,
                     bin_cap: int, tri_block: int = 32,
                     with_ids: bool = True,
                     tile_row_offset=None, num_tile_rows: int = None,
                     row_stride=None):
    """Pure-XLA tiled rasterizer over the binned pairs.

    Each tile processes up to ``bin_cap`` triangles from its contiguous run
    in ``bins.order`` in blocks of ``tri_block``, evaluating edge functions
    over the tile's pixels and keeping the nearest (z, tri_id) per pixel.

    Contiguous-band mode (test-only, see raster_pallas.rasterize_pallas):
    with tile_row_offset (traced ok) + num_tile_rows (static), only those
    tile rows of the full-screen bin table are rasterized, with GLOBAL
    tile origins — the band's fp math is bit-identical to the single-chip
    render.

    Interleaved mode: with row_stride=(n_dev, owner) and bins from the
    matching bin_triangles call, the owner's strided tile rows are
    rasterized in permuted-key order; output row s*TILE_H + r is TRUE tile
    row s * n_dev + owner (callers reassemble with a transpose). This is
    the mode parallel.sharded uses in production.

    Returns (depth (rows, W), tri_id or None).
    """
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    num_tiles = ntx * nty

    A, B, C, area2, top_left = _edge_coeffs(tris.xy)
    inv_a2 = 1.0 / jnp.where(area2 == 0, 1.0, area2)
    # depth plane z(p) = z0 + zA (px - x0) + zB (py - y0), anchored at
    # vertex 0: an edge-on triangle's slopes are large, and a plane
    # constant at the screen origin would cancel against them
    zA = (A * tris.z * inv_a2[:, None]).sum(-1)
    zB = (B * tris.z * inv_a2[:, None]).sum(-1)
    zv = jnp.stack([tris.z[:, 0], tris.xy[:, 0, 0], tris.xy[:, 0, 1]], -1)

    if row_stride is not None:
        n_dev, owner = row_stride
        rpd = -(-nty // n_dev)
        grid_tiles = rpd * ntx
        out_rows = rpd
        off = jnp.asarray(owner, jnp.int32) * grid_tiles
        starts_g = jax.lax.dynamic_slice_in_dim(bins.starts, off,
                                                grid_tiles)
        counts_g = jax.lax.dynamic_slice_in_dim(bins.counts, off,
                                                grid_tiles)
        slot_row = jnp.arange(grid_tiles, dtype=jnp.int32) // ntx
        true_ty = slot_row * n_dev + jnp.asarray(owner, jnp.int32)
        tile_y0 = (true_ty * TILE_H).astype(jnp.float32)
        tile_x0 = ((jnp.arange(grid_tiles, dtype=jnp.int32) % ntx)
                   * TILE_W).astype(jnp.float32)
    else:
        if num_tile_rows is None:
            starts_g, counts_g = bins.starts, bins.counts
            tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
            out_rows = nty
        else:
            out_rows = num_tile_rows
            grid_tiles = num_tile_rows * ntx
            off = jnp.asarray(tile_row_offset, jnp.int32) * ntx
            starts_g = jax.lax.dynamic_slice_in_dim(bins.starts, off,
                                                    grid_tiles)
            counts_g = jax.lax.dynamic_slice_in_dim(bins.counts, off,
                                                    grid_tiles)
            tile_ids = off + jnp.arange(grid_tiles, dtype=jnp.int32)
        tile_x0 = ((tile_ids % ntx) * TILE_W).astype(jnp.float32)
        tile_y0 = ((tile_ids // ntx) * TILE_H).astype(jnp.float32)

    # per-tile fixed-size bin lists (gathered from the sorted pair array)
    k = jnp.arange(bin_cap, dtype=jnp.int32)[None, :]
    idx = jnp.clip(starts_g[:, None] + k, 0, bins.order.shape[0] - 1)
    bin_tris = bins.order[idx]  # (num_tiles, bin_cap)
    bin_valid = k < counts_g[:, None]
    lx = (jnp.arange(TILE_W, dtype=jnp.float32) + 0.5)[None, :]
    ly = (jnp.arange(TILE_H, dtype=jnp.float32) + 0.5)[:, None]

    nblk = bin_cap // tri_block
    assert bin_cap % tri_block == 0

    def tile_fn(tids, tvalid, x0, y0):
        px = (x0 + lx).reshape(1, -1)  # (1, TW)
        py = (y0 + ly).reshape(-1, 1)  # (TH, 1)

        def body(carry, blk):
            depth, best = carry
            ids, vmask = blk
            Ab, Bb, Cb = A[ids], B[ids], C[ids]  # (TB, 3)
            tlb = top_left[ids]
            vb = vmask & tris.valid[ids]
            # E: (TB, 3, TH, TW)
            E = (Ab[:, :, None, None] * px[None, None]
                 + Bb[:, :, None, None] * py[None, None]
                 + Cb[:, :, None, None])
            inside = (E > 0) | ((E == 0) & tlb[:, :, None, None])
            cov = inside.all(axis=1) & vb[:, None, None]
            z0, vx, vy = (v[:, None, None] for v in zv[ids].T)
            zpix = (z0 + zA[ids][:, None, None] * (px[None] - vx)
                    + zB[ids][:, None, None] * (py[None] - vy))
            zpix = jnp.where(cov & (zpix >= 0.0) & (zpix <= 1.0), zpix, jnp.inf)
            zmin = zpix.min(axis=0)
            better = zmin < depth
            depth = jnp.where(better, zmin, depth)
            if with_ids:
                amin = jnp.argmin(zpix, axis=0)
                best = jnp.where(better, ids[amin], best)
            return (depth, best), None

        depth0 = jnp.full((TILE_H, TILE_W), 1.0, dtype=jnp.float32)
        best0 = jnp.full((TILE_H, TILE_W), -1, dtype=jnp.int32)
        blocks = (tids.reshape(nblk, tri_block), tvalid.reshape(nblk, tri_block))
        (depth, best), _ = jax.lax.scan(body, (depth0, best0), blocks)
        return depth, best

    depth_t, id_t = jax.vmap(tile_fn)(bin_tris, bin_valid, tile_x0, tile_y0)

    def assemble(flat):
        img = (flat.reshape(out_rows, ntx, TILE_H, TILE_W)
               .transpose(0, 2, 1, 3).reshape(out_rows * TILE_H,
                                              ntx * TILE_W))
        if num_tile_rows is None and row_stride is None:
            img = img[:height, :]
        return img[:, :width]

    return assemble(depth_t), (assemble(id_t) if with_ids else None)


def raster_stats(tris: ScreenTris, width: int, height: int,
                 pair_capacity: int, tile_h: int = None,
                 tile_w: int = None) -> dict:
    """Capacity diagnostics for a frame: total pairs, overflow flag, and the
    max per-tile triangle count (must stay <= bin_cap for the pure-XLA
    rasterizer, which truncates silently; the Pallas kernel has dynamic
    per-tile counts and only needs pair_capacity to hold the expansion)."""
    bins = bin_triangles(tris, width, height, pair_capacity, tile_h, tile_w)
    return dict(
        num_valid=int(bins.num_valid),
        overflowed=bool(bins.overflowed),
        max_tile_count=int(bins.counts.max()),
    )


def rasterize(clip_verts: jnp.ndarray, indices: jnp.ndarray, width: int,
              height: int, pair_capacity: int = 1 << 19, bin_cap: int = 1024,
              with_ids: bool = True, backend: str = "binned"):
    """End-to-end: clip-space vertices + indices -> (depth, tri_id)."""
    tris = setup_triangles(clip_verts, indices, width, height)
    if backend == "brute":
        return rasterize_bruteforce(tris, width, height)
    bins = bin_triangles(tris, width, height, pair_capacity)
    return rasterize_binned(tris, bins, width, height, bin_cap,
                            with_ids=with_ids)
