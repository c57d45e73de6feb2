"""Tile rasterization kernel for NVIDIA Hopper (Pallas through Triton).

The plain rasterizer (rasterizer.rasterize_binned) vmaps every screen
tile over a scan of ``bin_cap / tri_block`` blocks, so every tile pays for
the busiest tile of the frame, and it builds a (TB, 3, TH, TW) edge tensor
per block. This kernel does only the live (tile, triangle) pairs:

- grid = one program per screen tile; the scheduler spreads the skewed
  per-tile runs over the SMs;
- per-tile triangle runs are CONTIGUOUS in the sorted pair array (the
  binning sort's purpose), so each program reads its own (start, count)
  and walks [start, start + count) in blocks of TB records with masked
  loads, a dynamic trip count (empty tiles cost one load) and no gathers;
- the z-buffer and winning-id buffer stay in registers across the loop;
  edge and depth planes are (TB, 1) x (1, P) broadcast FMAs and each
  block folds into the running minimum with one reduction over TB.

Record layout (built by `build_records`): one row-major (16,) f32 record
per pair, so a block is one contiguous (TB, 16) load. Columns 0-2 = edge
A coeffs, 3-5 = B, 6-8 = TILE-LOCAL C (evaluated at the pair's tile
origin, which keeps |E| small inside the tile for f32 precision;
top-left-rule bias pre-applied), 9-11 = tile-local depth plane (zA, zB,
zC_local), 12 = triangle id as f32, 13-14 = tile-local atlas column guard
[xlo, xhi), 15 = padding.

Fill-rule note: vertex coordinates are snapped to 1/256-pixel fixed point
in `setup` (like D3D's 8-bit subpixel rasterizer), so the top-left rule is
an exact epsilon bias on C for in-tile coordinates.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import rasterizer as rz

# Tile and block sizes (powers of two), for the main view and the shadow
# atlas alike: a block holds TRI_BLOCK x TILE_H*TILE_W f32 values per live
# plane, which has to fit the SM's registers. Chosen by a sweep on an H100
# (PERF.md): 256-512-pixel tiles with 8-16 records per block are within
# noise of each other, and a 32-record block spills.
TILE_H = 8
TILE_W = 32
TRI_BLOCK = 16
NUM_WARPS = 4
NUM_STAGES = 2
SUBPIXEL = 256.0  # 1/256-pixel snapping (D3D subpixel grid)
# exact epsilon: snapped edge values are multiples of 1/SUBPIXEL^2
EDGE_EPS = 0.5 / (SUBPIXEL * SUBPIXEL)
REC_COLS = 16
ID_NONE = 3.0e7  # sentinel id (< 2^25 so float32-exact comparisons hold)


snap_xy = rz.snap_xy  # canonical snap lives with setup_tri_verts


def kernel_for_backend(platform: str) -> bool:
    """Whether a JAX backend rasterizes with this kernel: yes on the GPU,
    no on the CPU (the XLA reference, rasterizer.rasterize_binned)."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(
        f"no rasterizer for backend {platform!r}: the kernel compiles for "
        f"the GPU and the XLA reference runs on the CPU")


def tri_records(tris: rz.ScreenTris, xrange=None) -> jnp.ndarray:
    """Per-TRIANGLE source rows (T, 16) f32 for build_records: snapped
    vertex xy (6), vertex z (3), id, column guard [xlo, xhi), zero pad.

    xrange: optional (xlo (T,), xhi (T,)) viewport columns — coverage is
    masked to pixel centers with xlo <= x < xhi. Used by the shadow ATLAS,
    where each cascade owns a column and triangles extending past their
    cascade's viewport must not bleed into the neighbor (the per-cascade
    path gets this for free from its own viewport bounds)."""
    T = tris.xy.shape[0]
    ids = jnp.arange(T, dtype=jnp.float32)
    if xrange is None:
        xlo = jnp.full_like(ids, -3e7)
        xhi = jnp.full_like(ids, 3e7)
    else:
        xlo, xhi = xrange
    return jnp.concatenate(
        [snap_xy(tris.xy).reshape(T, 6), tris.z,
         jnp.stack([ids, xlo, xhi], axis=-1),
         jnp.zeros((T, 4), jnp.float32)], axis=-1)


def _raster_kernel(start_ref, count_ref, rec_ref, depth_ref, *tid_ref,
                   with_ids: bool, with_xrange: bool):
    """One screen tile: walk its run of pair records in TRI_BLOCK blocks.

    Exact-z tie rule: the minimum id within a block, the earliest block
    across blocks. These coincide: the stable tile sort keeps each run's
    triangle ids ASCENDING, so the earliest block holding the min z also
    holds the smallest tied id — making the winner independent of where
    band/interleaved binning shifts the run (sharded tid == single-card
    tid even on coplanar geometry)."""
    P = TILE_H * TILE_W
    pidx = jax.lax.broadcasted_iota(jnp.int32, (1, P), 1)
    px = (pidx % TILE_W).astype(jnp.float32) + 0.5
    py = (pidx // TILE_W).astype(jnp.float32) + 0.5
    sub = jax.lax.broadcasted_iota(jnp.int32, (TRI_BLOCK, 1), 0)
    start = start_ref[0]
    count = count_ref[0]

    def body(b, carry):
        z_best, id_best = carry
        live = b * TRI_BLOCK + sub < count  # (TB, 1)
        rec = plgpu.load(rec_ref.at[pl.ds(start + b * TRI_BLOCK, TRI_BLOCK),
                                    :],
                         mask=jnp.broadcast_to(live, (TRI_BLOCK, REC_COLS)),
                         other=0.0)
        col = jnp.split(rec, REC_COLS, axis=1)  # 16 x (TB, 1)
        E0 = col[0] * px + col[3] * py + col[6]
        E1 = col[1] * px + col[4] * py + col[7]
        E2 = col[2] * px + col[5] * py + col[8]
        cov = (jnp.minimum(jnp.minimum(E0, E1), E2) >= 0.0) & live
        if with_xrange:
            # atlas column guard: pixel center x within [xlo, xhi)
            cov = cov & (px >= col[13]) & (px < col[14])
        z = col[9] * px + col[10] * py + col[11]
        z = jnp.where(cov & (z >= 0.0) & (z <= 1.0), z, jnp.inf)
        zb = jnp.min(z, axis=0, keepdims=True)  # (1, P)
        better = zb < z_best
        z_best = jnp.where(better, zb, z_best)
        if with_ids:
            idb = jnp.min(jnp.where(z == zb, col[12], jnp.inf), axis=0,
                          keepdims=True)
            id_best = jnp.where(better, idb, id_best)
        return z_best, id_best

    init = (jnp.full((1, P), 1.0, jnp.float32),
            jnp.full((1, P), ID_NONE, jnp.float32))
    z_best, id_best = jax.lax.fori_loop(0, pl.cdiv(count, TRI_BLOCK), body,
                                        init)
    depth_ref[...] = z_best.reshape(TILE_H, TILE_W)
    if with_ids:
        tid_ref[0][...] = jnp.where(id_best < ID_NONE, id_best,
                                    -1.0).astype(jnp.int32).reshape(
                                        TILE_H, TILE_W)


def build_records(tris: rz.ScreenTris, bins: rz.Bins, ntx: int,
                  num_tiles: int, xrange=None, row_unperm=None):
    """Tile-anchored pair records (P + TRI_BLOCK, 16) for the kernel (the
    layout is in the module doc): edge and depth planes and the column
    guard evaluated at each pair's tile origin. The TRI_BLOCK zero rows
    at the end keep every block window of a run inside the array (its
    masked rows are never used)."""
    trecs = tri_records(tris, xrange)
    src = trecs[bins.order]  # (P, 16): one 64-byte row gather per pair
    tile_of = jnp.minimum(bins.sorted_tile, num_tiles - 1)

    # With row_unperm=(n_dev, rows_per_dev), sorted_tile holds OWNER-MAJOR
    # permuted keys (interleaved binning): recover the true tile row
    # analytically — key_row = owner * rpd + ty // n_dev.
    x0 = ((tile_of % ntx) * TILE_W).astype(jnp.float32)[:, None]
    if row_unperm is None:
        y0 = ((tile_of // ntx) * TILE_H).astype(jnp.float32)[:, None]
    else:
        n_dev, rpd = row_unperm
        kr = tile_of // ntx
        true_ty = (kr % rpd) * n_dev + kr // rpd
        y0 = (true_ty * TILE_H).astype(jnp.float32)[:, None]
    # Vertices relative to the tile origin: exact for snapped coordinates,
    # so the edge functions and the top-left bias below are exact inside
    # the tile however far the tile is from the screen origin.
    xy = jnp.stack([src[:, 0:6:2] - x0, src[:, 1:6:2] - y0], axis=-1)
    z = src[:, 6:9]
    A, B, C, area2, top_left = rz._edge_coeffs(xy)
    inv_a2 = 1.0 / jnp.where(area2 == 0, 1.0, area2)
    zA = (A * z * inv_a2[:, None]).sum(-1)
    zB = (B * z * inv_a2[:, None]).sum(-1)
    # depth plane anchored at vertex 0: an edge-on triangle's slopes are
    # large, and only the short vertex-to-tile offset multiplies them
    zC = z[:, 0] - zA * xy[:, 0, 0] - zB * xy[:, 0, 1]
    C = C - jnp.where(top_left, 0.0, EDGE_EPS)
    rec = jnp.concatenate(
        [A, B, C, jnp.stack([zA, zB, zC, src[:, 9]], axis=-1),
         src[:, 10:12] - x0, jnp.zeros_like(x0)], axis=-1)
    return jnp.pad(rec, ((0, TRI_BLOCK), (0, 0)))


def rasterize_pallas(tris: rz.ScreenTris, width: int, height: int,
                     pair_capacity: int, interpret: bool = False,
                     with_ids: bool = True, xrange=None, row_stride=None):
    """Full pipeline: bin (XLA) + raster (the kernel).

    Triangle setup must use the same snapped coordinates the records use,
    so callers should pass `tris` from rz.setup_triangles unchanged — the
    snapping happens inside build_records (binning bboxes stay
    conservative either way).

    Interleaved mode (``row_stride=(n_dev, owner)``, what parallel.sharded
    uses): binning keeps only the owner's tile rows, with owner-major
    permuted keys (see rz.bin_triangles), so the owner's tiles are one
    contiguous key range. Every record keeps its GLOBAL tile anchor, so
    the f32 math is bit-identical to the single-card render. Output row
    s*TILE_H + r is TRUE tile row s*n_dev + owner.

    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests).

    Returns (depth (H, W) f32, tid (H, W) i32 or None); pairs beyond
    pair_capacity are dropped, which Renderer's capacity checks prevent.
    """
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    bins = rz.bin_triangles(tris, width, height, pair_capacity,
                            tile_h=TILE_H, tile_w=TILE_W,
                            row_stride=row_stride)
    if row_stride is not None:
        n_dev, owner = row_stride
        rpd = -(-nty // n_dev)
        records = build_records(tris, bins, ntx, rpd * n_dev * ntx, xrange,
                                row_unperm=(n_dev, rpd))
        out_rows = rpd
        off = jnp.asarray(owner, jnp.int32) * (rpd * ntx)
    else:
        records = build_records(tris, bins, ntx, ntx * nty, xrange)
        out_rows = nty
        off = jnp.int32(0)
    grid_tiles = out_rows * ntx
    starts = jax.lax.dynamic_slice_in_dim(bins.starts, off, grid_tiles)
    counts = jax.lax.dynamic_slice_in_dim(bins.counts, off, grid_tiles)

    kernel = functools.partial(_raster_kernel, with_ids=with_ids,
                               with_xrange=xrange is not None)
    img_shape = (out_rows * TILE_H, ntx * TILE_W)
    tile_spec = pl.BlockSpec((TILE_H, TILE_W), lambda r, c: (r, c))
    scalar_spec = pl.BlockSpec((1,), lambda r, c: (r * ntx + c,))
    out_shape = [jax.ShapeDtypeStruct(img_shape, jnp.float32)]
    if with_ids:
        out_shape.append(jax.ShapeDtypeStruct(img_shape, jnp.int32))
    outs = pl.pallas_call(
        kernel,
        grid=(out_rows, ntx),
        in_specs=[scalar_spec, scalar_spec,
                  pl.BlockSpec(records.shape, lambda r, c: (0, 0))],
        out_specs=[tile_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="raster_tiles",
    )(starts, counts, records)

    def crop(img):
        if row_stride is None:
            img = img[:height, :]
        return img[:, :width]

    return crop(outs[0]), crop(outs[1]) if with_ids else None
