"""Cascaded shadow lookup: 16-tap rotated-Poisson PCF with a bilinear
comparison sampler, cascade selection by view distance, cross-cascade blend.

Re-implements /root/reference/Shaders/Common.hlsl:135-316 (CalcShadowFactor,
CalcCascadeShadowFactorWithPoisson and friends) and the cascade-selection
loops of Default.hlsl:124-149 (forward) / DeferredShading.hlsl:53-76
(deferred). The shadow sampler is D3D comparison LESS_EQUAL with linear
filtering and OPAQUE_BLACK border (CRYCHIC.cpp:2649-2658): each tap
bilinearly blends four per-texel (pixel_depth <= texel_depth) results, and
taps outside the map compare against 0 (always shadowed).

Deferred-path quirk replicated: the blend condition
``abs(distance - radius[j] < 5.0f)`` (DeferredShading.hlsl:60) casts the
comparison to bool before abs, so the deferred shader ALWAYS blends
cascades j and j+1.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..models.cascades import CASCADE_RADII

# Poisson disk (Common.hlsl:173-183).
POISSON_DISK = np.array(
    [
        [-0.94201624, -0.39906216], [0.94558609, -0.76890725],
        [-0.094184101, -0.92938870], [0.34495938, 0.29387760],
        [-0.91588581, 0.45771432], [-0.81544232, -0.87912464],
        [-0.38277543, 0.27676845], [0.97484398, 0.75648379],
        [0.44323325, -0.97511554], [0.53742981, -0.47373420],
        [-0.26496911, -0.41893023], [0.79197514, 0.19090188],
        [-0.24188840, 0.99706507], [-0.81409955, 0.91437590],
        [0.19984126, 0.78641367], [0.14383161, -0.14100790],
    ],
    dtype=np.float32,
)
N_SAMPLE = 16


def nrand(uv):
    """Common.hlsl:167-171 hash (the float2 collapses to one scalar)."""
    s = jnp.sin(uv[..., 0] * (12.9898 * 2.0) + uv[..., 1] * (78.233 * 2.0))
    v = s * 43758.5453
    return jnp.abs(v - jnp.floor(v))


def compiled_poisson_radius_uv(smap_size: int) -> float:
    """The Poisson search radius AS COMPILED by the reference.

    Common.hlsl:301 reads `float search_radius = 5 / width / 2.0f;` where
    `width` is the uint filled by GetDimensions (:287). `5 / width` is an
    int/uint division (HLSL arithmetic conversions promote the int literal
    to uint), so it is 0 for every real map size — the author casts width
    to float for `dx` two lines above (:288) but not here. The compiled
    shader's 16 rotated-Poisson taps therefore all land on the receiver:
    the reference's PCF is ONE bilinear comparison tap repeated 16 times.
    Replicated for image parity (and asserted against the independent
    transliteration in tests/test_hlsl_oracle.py); the intended 2.5-texel
    soft disk remains available via RenderConfig.pcf_radius_texels.
    """
    return float(5 // smap_size) / 2.0


def _cmp_sample_bilinear(shadow_maps, cascade, u, v, depth):
    """One SampleCmpLevelZero tap: bilinear blend of (depth <= texel) with
    black-border behavior outside [0,1]^2.

    shadow_maps: (C, S, S); cascade/u/v/depth: (...,).
    """
    S = shadow_maps.shape[1]
    x = u * S - 0.5
    y = v * S - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def texel(cx, cy):
        inb = (cx >= 0) & (cx < S) & (cy >= 0) & (cy < S)
        cxx = jnp.clip(cx, 0, S - 1)
        cyy = jnp.clip(cy, 0, S - 1)
        d = shadow_maps[cascade, cyy, cxx]
        d = jnp.where(inb, d, 0.0)  # border = opaque black (depth 0)
        return (depth <= d).astype(jnp.float32)

    c00 = texel(x0i, y0i)
    c10 = texel(x0i + 1, y0i)
    c01 = texel(x0i, y0i + 1)
    c11 = texel(x0i + 1, y0i + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def poisson_pcf(shadow_maps, cascade, shadow_pos, smap_size: int,
                soft_radius_texels: float = None):
    """CalcCascadeShadowFactorWithPoisson (Common.hlsl:263-316).

    shadow_pos: (..., 4) homogeneous position in shadow-texture space
    (world @ shadow_transform, pre-divide). cascade: (...,) int32.
    soft_radius_texels: None replicates the COMPILED reference (radius 0,
    see compiled_poisson_radius_uv); a value (e.g. 2.5, the intended
    `5/width/2` had width been cast) spreads the disk.
    """
    inv_w = 1.0 / jnp.maximum(shadow_pos[..., 3], 1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    u, v, depth = uvz[..., 0], uvz[..., 1], uvz[..., 2]

    theta = nrand(uvz[..., :2])
    c, s = jnp.cos(theta), jnp.sin(theta)
    if soft_radius_texels is None:
        radius = compiled_poisson_radius_uv(smap_size)
    else:
        radius = soft_radius_texels / smap_size

    lit = jnp.zeros_like(u)
    for i in range(N_SAMPLE):
        px, py = POISSON_DISK[i]
        # mul(p, R) with R = [[c, s], [-s, c]] (row-vector)
        ox = (px * c - py * s) * radius
        oy = (px * s + py * c) * radius
        lit = lit + _cmp_sample_bilinear(shadow_maps, cascade, u + ox, v + oy,
                                         depth)
    return lit / N_SAMPLE


def grid_pcf(shadow_maps, cascade, shadow_pos, smap_size: int,
             radius_texels: int = 1):
    """CalcCascadeShadowFactor3X3 / 5X5 (Common.hlsl:185-261): dense
    (2r+1)^2 comparison taps at 1-texel spacing. radius_texels=1 is the
    3x3 box, 2 the 5x5 box."""
    inv_w = 1.0 / jnp.maximum(shadow_pos[..., 3], 1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    u, v, depth = uvz[..., 0], uvz[..., 1], uvz[..., 2]
    dx = 1.0 / smap_size
    lit = jnp.zeros_like(u)
    n = 0
    for oy in range(-radius_texels, radius_texels + 1):
        for ox in range(-radius_texels, radius_texels + 1):
            lit = lit + _cmp_sample_bilinear(
                shadow_maps, cascade, u + ox * dx, v + oy * dx, depth)
            n += 1
    return lit / n


def block_shadow_maps(shadow_maps):
    """(C, S, S) -> (C, S/8, S/8, 64): 8x8 texel blocks flat at 64 wide
    (the compact layout the windowed PCF gathers from)."""
    C, S, _ = shadow_maps.shape
    nb = S // 8
    return shadow_maps.reshape(C, nb, 8, nb, 8).transpose(
        0, 1, 3, 2, 4).reshape(C, nb, nb, 64)


def superwindow_maps(shadow_maps):
    """(C, S, S) -> (C, S/8, S/8, 256): for every 8x8 block, the flat
    ROW-MAJOR 16x16 superwindow covering it and its +1 neighbors
    (edge-clamped): flat index f = wy*16 + wx, wy/wx in [0, 16).
    Gather latency is per ROW, so one 1KB-row gather per receiver beats
    four 64-wide block gathers 4x; the 4x duplication is rebuilt per frame
    with dense ops (cheap) since shadow maps are re-rendered each frame.
    Row-major (rather than block-quad) ordering makes an 8-row y-window
    a contiguous lane slice, enabling poisson_pcf_windowed's exact
    half-window extraction."""
    C, S, _ = shadow_maps.shape
    nb = S // 8
    b = shadow_maps.reshape(C, nb, 8, nb, 8).transpose(0, 1, 3, 2, 4)
    ip = jnp.minimum(jnp.arange(nb) + 1, nb - 1)
    bx = b[:, :, ip]
    by = b[:, ip]
    bxy = by[:, :, ip]
    top = jnp.concatenate([b, bx], axis=-1)    # (C, nb, nb, 8, 16)
    bot = jnp.concatenate([by, bxy], axis=-1)  # rows 8..15
    sw = jnp.concatenate([top, bot], axis=-2)  # (C, nb, nb, 16, 16)
    return sw.reshape(C, nb, nb, 256)  # row-major windows


def pack_depth_rows_u16(x):
    """f32 (..., 2K) depths in [0,1] -> u32 (..., K): 16-bit UNORM
    quantize + pack 2 texels per lane — the elementwise head of
    superwindow_maps_u16, exposed so parallel.sharded can pack each
    device's atlas rows BEFORE the all_gather (quantization is per-texel,
    so it commutes with row reassembly bit-exactly and halves the
    exchanged + transposed bytes)."""
    q = jnp.round(jnp.clip(x, 0.0, 1.0) * 65535.0).astype(jnp.uint32)
    return q[..., 0::2] | (q[..., 1::2] << 16)


def superwindow_from_packed(p):
    """(C, S, S/2) u32 packed texel-pair rows -> (C, S/8, S/8, 128) u32:
    the block-shuffle tail of superwindow_maps_u16 (see there)."""
    C, S, _ = p.shape
    nb = S // 8
    b = p.reshape(C, nb, 8, nb, 4).transpose(0, 1, 3, 2, 4)
    ip = jnp.minimum(jnp.arange(nb) + 1, nb - 1)
    bx = b[:, :, ip]
    by = b[:, ip]
    bxy = by[:, :, ip]
    top = jnp.concatenate([b, bx], axis=-1)          # (C, nb, nb, 8, 8)
    bot = jnp.concatenate([by, bxy], axis=-1)
    sw = jnp.concatenate([top, bot], axis=-2)        # (C, nb, nb, 16, 8)
    return sw.reshape(C, nb, nb, 128)  # row-major packed windows


def superwindow_maps_u16(shadow_maps):
    """(C, S, S) -> (C, S/8, S/8, 128) uint32: the 16x16 superwindow with
    depths quantized to 16-bit UNORM, packed 2 texels per u32 lane.

    Halves the gathered table AND the row width vs the f32 superwindow
    (its speed on the GPU is not yet measured; ROADMAP S5). Quantization
    error is <= 7.7e-6, two orders of magnitude
    below the replicated shadow depth bias (10000/2^24 ~= 6e-4,
    CRYCHIC.cpp:1601), so PCF acceptance is unchanged in practice; the
    reference itself compares against 24-bit UNORM depth (R24G8).

    Quantize + pack runs BEFORE the block shuffle so the transpose moves
    u32 pairs instead of f32 texels (half the bytes of packing last)."""
    return superwindow_from_packed(pack_depth_rows_u16(shadow_maps))


def _quad_rows_from_u16(qi):
    """(C, S, S) int32/uint32 16-bit depth values -> (C*(S+2)^2, 2) u32
    quad rows: for every texel of the zero-PADDED map (1-texel border of
    depth 0 = the gsamShadow OPAQUE_BLACK border), its 2x2 neighborhood
    packed as two x-pair lanes [t00|t10<<16, t01|t11<<16]."""
    qi = qi.astype(jnp.uint32)
    C = qi.shape[0]
    p = jnp.pad(qi, ((0, 0), (1, 1), (1, 1)))
    x1 = jnp.pad(p[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
    top = p | (x1 << 16)
    y1 = jnp.pad(top[:, 1:, :], ((0, 0), (0, 1), (0, 0)))
    return jnp.stack([top, y1], axis=-1).reshape(-1, 2)


def quad_maps_u16(shadow_maps):
    """(C, S, S) f32 depth -> (C*(S+2)^2, 2) u32 8-BYTE quad rows.

    The zero-radius PCF table: with the compiled Poisson radius of 0 the
    filter needs only the receiver's 2x2 texel quad, so an 8-byte row
    replaces the 512-byte superwindow row. Same 4x texel redundancy /
    table bytes-per-cascade as the superwindow, but the narrow rows keep
    the gather stream cache-resident (screen-local receivers hit
    map-local quads)."""
    q = jnp.round(jnp.clip(shadow_maps, 0.0, 1.0) * 65535.0)
    return _quad_rows_from_u16(q.astype(jnp.uint32))


def quad_from_packed(p):
    """(C, S, S/2) u32 packed texel-pair rows (pack_depth_rows_u16) ->
    (C*(S+2)^2, 2) u32 quad rows — the already-quantized atlas-exchange
    path (parallel.sharded ships u16)."""
    e = p & 0xFFFF
    o = p >> 16
    qi = jnp.stack([e, o], axis=-1).reshape(p.shape[0], p.shape[1], -1)
    return _quad_rows_from_u16(qi)


def pcf_single_tap(qrows, cascade, shadow_pos, smap_size: int,
                   spread_mask=None):
    """One bilinear comparison tap from 8-byte quad rows — the compiled
    reference's ENTIRE Poisson PCF (radius 0, compiled_poisson_radius_uv):
    bit-identical to poisson_pcf_windowed(..., soft_radius_texels=None)
    for in-map receivers, and EXACT for the black border (the windowed
    path clamps there). ONE row gather per pixel.

    spread_mask: receivers whose factor is DISCARDED downstream (sky
    pixels, and dist>=100 no-shadow pixels whose factor is forced to 1) —
    their extrapolated projections either pile onto the clamped border
    quads (gather hot-row serialization) or scatter across the map at
    full gather price. Substitute a compact in-map window for the tap
    INDEX only; live receivers are bit-identical."""
    S = smap_size
    P = S + 2
    inv_w = 1.0 / jnp.maximum(shadow_pos[..., 3], 1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    u, v, depth = uvz[..., 0], uvz[..., 1], uvz[..., 2]
    cx = u * S - 0.5
    cy = v * S - 0.5
    x0 = jnp.floor(cx).astype(jnp.int32)
    y0 = jnp.floor(cy).astype(jnp.int32)
    fx = cx - x0.astype(jnp.float32)
    fy = cy - y0.astype(jnp.float32)
    xq = jnp.clip(x0 + 1, 0, P - 1)
    yq = jnp.clip(y0 + 1, 0, P - 1)
    if spread_mask is not None and xq.ndim >= 2:
        iy = jax.lax.broadcasted_iota(jnp.int32, xq.shape, xq.ndim - 2)
        ix = jax.lax.broadcasted_iota(jnp.int32, xq.shape, xq.ndim - 1)
        xq = jnp.where(spread_mask, ix % 32 + 1, xq)
        yq = jnp.where(spread_mask, iy % 32 + 1, yq)
    row = qrows[(cascade * P + yq) * P + xq]  # (..., 2) u32 — ONE gather
    dq = depth * 65535.0 - 0.5
    c00 = (dq <= (row[..., 0] & 0xFFFF).astype(jnp.float32)).astype(
        jnp.float32)
    c10 = (dq <= (row[..., 0] >> 16).astype(jnp.float32)).astype(
        jnp.float32)
    c01 = (dq <= (row[..., 1] & 0xFFFF).astype(jnp.float32)).astype(
        jnp.float32)
    c11 = (dq <= (row[..., 1] >> 16).astype(jnp.float32)).astype(
        jnp.float32)
    lit = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    # receivers whose quad lies fully outside the padded ring read pure
    # border (all taps black): SampleCmpLevelZero returns 0 there
    far = (x0 < -1) | (x0 > S - 1) | (y0 < -1) | (y0 > S - 1)
    return jnp.where(far, 0.0, lit)


def _unpack_u16_window(w32):
    """(..., K) u32 -> (..., 2K) f32 in 16-bit UNORM steps (0..65535)."""
    e = (w32 & 0xFFFF).astype(jnp.float32)
    o = (w32 >> 16).astype(jnp.float32)
    return jnp.stack([e, o], axis=-1).reshape(
        w32.shape[:-1] + (2 * w32.shape[-1],))


def poisson_pcf_windowed(shadow_maps, cascade, shadow_pos, smap_size: int,
                         soft_radius_texels: float = None):
    """Windowed formulation of the 16-tap rotated-Poisson PCF.

    ``shadow_maps`` may be (C, S, S) raw, (C, S/8, S/8, 256) f32
    pre-superwindowed, or (C, S/8, S/8, 128) uint32 u16-packed
    (pass smap_size = S either way).

    Mathematically identical to `poisson_pcf` in both radius modes:

    - soft_radius_texels=None (default) replicates the COMPILED reference
      radius of 0 (Common.hlsl:301 int/uint division — see
      compiled_poisson_radius_uv): all 16 taps coincide at the receiver,
      so the filter is ONE bilinear comparison tap, evaluated from the
      same window gather with a single tent (the ~15x cheaper path).
    - soft_radius_texels=2.5 evaluates the intended rotated disk: every
      tap's bilinear footprint lies in an 8x8-texel window around the
      receiver. One sliced gather fetches the window; the 16 taps'
      bilinear weights are accumulated into a mask and combined with the
      window's depth comparisons in one fused elementwise reduction —
      O(1) gathers per pixel instead of 64.

    Border approximation: the window origin clamps to the map, so taps that
    would read the black border instead read edge texels. Cascade fitting
    keeps receivers inside the map, making this unreachable in practice.
    """
    S = smap_size
    inv_w = 1.0 / jnp.maximum(shadow_pos[..., 3], 1e-20)
    uvz = shadow_pos[..., :3] * inv_w[..., None]
    u, v, depth = uvz[..., 0], uvz[..., 1], uvz[..., 2]

    cx = u * S - 0.5
    cy = v * S - 0.5
    # Layout: the shadow maps are re-blocked into 16x16-texel superwindows
    # anchored per 8x8 block — u16-quantized and packed 2-per-u32 lane
    # (128-wide rows) — and each receiver fetches its whole window as ONE
    # flat row gather. All tap math below is elementwise over the flat
    # axis.
    if shadow_maps.ndim == 4 and shadow_maps.dtype == jnp.uint32:
        swin = shadow_maps
    elif shadow_maps.ndim == 4:
        sw = shadow_maps
        q = jnp.round(jnp.clip(sw, 0.0, 1.0) * 65535.0).astype(jnp.uint32)
        swin = q[..., 0::2] | (q[..., 1::2] << 16)
    else:
        swin = superwindow_maps_u16(shadow_maps)
    nb = swin.shape[1]

    # base block: the 8-texel window [floor(c)-3, floor(c)+4] always fits
    # in blocks q0, q0+1 where q0 = (floor(c) - 3) >> 3
    x_lo = jnp.floor(cx).astype(jnp.int32) - 3
    y_lo = jnp.floor(cy).astype(jnp.int32) - 3
    qx0 = jnp.clip(x_lo >> 3, 0, nb - 1)
    qy0 = jnp.clip(y_lo >> 3, 0, nb - 1)

    # flat 1D take: one row index per pixel
    shape = u.shape
    flat = swin.reshape(-1, swin.shape[-1])
    idx = (cascade * nb + qy0) * nb + qx0
    win_p = flat[idx]  # (..., 128) u32 packed — ONE row gather per pixel

    # Y sub-window extraction (64 lanes = 8 rows of the window):
    # a tap's tent support in y is (cy - (2.5|p|+1), cy + (2.5|p|+1)).
    # For the 13 disk entries with |p| < 1.2 that is under 4 texels, i.e.
    # integer rows floor(cy)-3 .. floor(cy)+4 — exactly 8 rows, extracted
    # as one contiguous 64-lane slice of the row-major packed window
    # (selected from the 8 block-aligned offsets). The 3 long entries of
    # the reference's (not-unit-norm, |p| up to 1.234) disk reach 10 rows
    # and are evaluated on the full 16-row window. Identical results to
    # the full evaluation at ~1.5x less tap arithmetic.
    inner = [i for i in range(N_SAMPLE)
             if float(np.hypot(*POISSON_DISK[i])) < 1.2]
    outer = [i for i in range(N_SAMPLE) if i not in inner]
    oy = jnp.clip(y_lo - qy0 * 8, 0, 7)
    ext = win_p[..., 0:64]
    for v in range(1, 8):
        ext = jnp.where((oy == v)[..., None], win_p[..., 8 * v:8 * v + 64],
                        ext)
    win8 = _unpack_u16_window(ext)       # (..., 128): 8 rows x 16 x
    dq = depth[..., None] * 65535.0 - 0.5
    cmp8 = (dq <= win8).astype(jnp.float32)

    m8 = np.arange(128)
    sy8 = jnp.asarray((m8 // 16).astype(np.float32))   # r in [0, 8)
    sx8 = jnp.asarray((m8 % 16).astype(np.float32))    # wx in [0, 16)

    fx_base = cx - (qx0 * 8).astype(jnp.float32)  # superwindow-local
    fy_base = cy - (qy0 * 8).astype(jnp.float32)
    fy_rel = fy_base - oy.astype(jnp.float32)

    if soft_radius_texels is None:
        # Compiled-reference radius 0 (compiled_poisson_radius_uv): all 16
        # taps coincide at the receiver, so percentLit/16 is ONE bilinear
        # comparison tap — a single tent over the 8-row extraction (its
        # 2x2 support sits at rows/cols 3-5 of the window). The rotation
        # hash is computed by the shader but multiplies a zero radius, so
        # it is dropped here; values are bit-identical.
        wx1 = jnp.maximum(1.0 - jnp.abs(sx8 - fx_base[..., None]), 0.0)
        wy1 = jnp.maximum(1.0 - jnp.abs(sy8 - fy_rel[..., None]), 0.0)
        return (cmp8 * wy1 * wx1).sum(axis=-1)

    assert soft_radius_texels <= 2.5, \
        "window extraction bounds assume the disk radius <= 2.5 texels"
    win16 = _unpack_u16_window(win_p)    # (..., 256): full window
    cmp16 = (dq <= win16).astype(jnp.float32)
    m16 = np.arange(256)
    sy16 = jnp.asarray((m16 // 16).astype(np.float32))
    sx16 = jnp.asarray((m16 % 16).astype(np.float32))

    theta = nrand(uvz[..., :2])
    c, sn = jnp.cos(theta), jnp.sin(theta)
    radius = float(soft_radius_texels)  # tap offsets in texels

    # accumulate each tap's bilinear weights over its window; a bilinear
    # weight is the tent function relu(1 - |grid - tap|), which is
    # branchless (4 elementwise ops per axis instead of two selects)
    def tap_xy(i):
        pxd, pyd = POISSON_DISK[i]
        return ((pxd * c - pyd * sn) * radius,
                (pxd * sn + pyd * c) * radius)

    Wacc8 = jnp.zeros(shape + (128,), jnp.float32)
    for i in inner:
        dx, dy = tap_xy(i)
        wx = jnp.maximum(1.0 - jnp.abs(sx8 - (fx_base + dx)[..., None]), 0.0)
        wy = jnp.maximum(1.0 - jnp.abs(sy8 - (fy_rel + dy)[..., None]), 0.0)
        Wacc8 = Wacc8 + wy * wx
    Wacc16 = jnp.zeros(shape + (256,), jnp.float32)
    for i in outer:
        dx, dy = tap_xy(i)
        wx = jnp.maximum(1.0 - jnp.abs(sx16 - (fx_base + dx)[..., None]), 0.0)
        wy = jnp.maximum(1.0 - jnp.abs(sy16 - (fy_base + dy)[..., None]), 0.0)
        Wacc16 = Wacc16 + wy * wx

    return ((cmp8 * Wacc8).sum(axis=-1)
            + (cmp16 * Wacc16).sum(axis=-1)) / N_SAMPLE


def cascade_shadow_factor(shadow_maps, shadow_transforms, pos_w, eye_pos,
                          smap_size: int, deferred_blend_quirk: bool,
                          soft_radius_texels: float = None, dead=None):
    """Per-pixel cascade select + PCF + blend.

    shadow_maps: (4, S, S) depth; shadow_transforms: (4, 4, 4) row-vector
    world->uv/depth; pos_w: (..., 3); eye_pos: (3,).
    Forward path (Default.hlsl:124-149): blend only within 10 units of the
    cascade boundary. Deferred path quirk: always blend (see module doc).
    Distance >= 100 -> no shadow (factor 1). soft_radius_texels: None =
    the compiled reference's zero Poisson radius (single comparison tap,
    compiled_poisson_radius_uv); 2.5 = the intended soft disk.
    """
    radii = jnp.asarray(CASCADE_RADII)
    dist = jnp.sqrt(((eye_pos - pos_w) ** 2).sum(-1))
    # first cascade whose radius exceeds the distance; 4 = none
    past = (dist[..., None] >= radii).sum(-1).astype(jnp.int32)
    c = jnp.clip(past, 0, 3)
    no_shadow = past >= 4

    ph = jnp.concatenate([pos_w, jnp.ones_like(pos_w[..., :1])], axis=-1)

    # Project by ALL cascades densely (4 small matmuls) and select per
    # pixel — a per-pixel (4,4)-matrix gather would be tiled to (8,128)
    # and inflate 256x.
    from .shading import rowmat

    all_pos = jnp.stack([rowmat(ph, shadow_transforms[ci])
                         for ci in range(4)])  # (4, ..., 4)

    def shadow_pos_for(cascade_idx):
        # rank-generic one-hot select over the leading cascade axis
        sel = (jnp.arange(4).reshape((4,) + (1,) * (cascade_idx.ndim + 1))
               == cascade_idx[None, ..., None]).astype(all_pos.dtype)
        return (all_pos * sel).sum(axis=0)

    if soft_radius_texels is None:
        # compiled-reference radius 0: one bilinear comparison tap from
        # 8-BYTE quad rows (pcf_single_tap) instead of 512-byte window
        # rows — same table bytes, but the narrow rows keep the gather
        # cache-resident and skip the window extract/unpack/tent work
        # entirely
        def quads_of(maps):
            if maps.dtype == jnp.uint32 and maps.ndim == 3:
                return quad_from_packed(maps)
            return quad_maps_u16(maps)

        # taps whose factor is discarded: no_shadow receivers are forced
        # to 1.0 below, and `dead` (sky) receivers' lighting is replaced
        # by the sky pass — spread their gathers over a compact window
        # (bit-exact; see pcf_single_tap docstring)
        spread = no_shadow if dead is None else (no_shadow | dead)
        if shadow_maps.shape[0] == 4:
            # cascade-PARITY table split (see the superwindow branch)
            q_e = quads_of(shadow_maps[0::2])
            q_o = quads_of(shadow_maps[1::2])
            even = (c & 1) == 0
            ce = jnp.where(even, c, jnp.minimum(c + 1, 2))
            co = jnp.where(even, c + 1, c)
            f_e = pcf_single_tap(q_e, ce >> 1, shadow_pos_for(ce),
                                 smap_size, spread_mask=spread)
            f_o = pcf_single_tap(q_o, co >> 1, shadow_pos_for(co),
                                 smap_size, spread_mask=spread)
            f_c = jnp.where(even, f_e, f_o)
            f_n = jnp.where(even, f_o, f_e)
        else:
            q = quads_of(shadow_maps)
            c_next = jnp.minimum(c + 1, 3)
            f_c = pcf_single_tap(q, c, shadow_pos_for(c), smap_size,
                                 spread_mask=spread)
            f_n = pcf_single_tap(q, c_next, shadow_pos_for(c_next),
                                 smap_size, spread_mask=spread)
        if deferred_blend_quirk:
            blend = c < 3
        else:
            blend = (c < 3) & (jnp.abs(dist - radii[c]) < 10.0)
        factor = jnp.where(blend, 0.5 * (f_c + f_n), f_c)
        if dead is not None:
            # deterministic value for discarded receivers: at parity the
            # sky pass overwrites them; in the half-res fast path their
            # value leaks into silhouette pixels through the bilinear
            # upsample, and 1.0 (unshadowed) beats the extrapolated
            # garbage projection it replaces
            factor = jnp.where(dead, 1.0, factor)
        return jnp.where(no_shadow, 1.0, factor)

    def swin_of(maps):
        if maps.dtype == jnp.uint32 and maps.ndim == 3:
            # pre-packed (C, S, S/2) texel-pair rows — parallel.sharded's
            # atlas exchange ships u16 to halve the all-gather and
            # reassembly bytes
            return superwindow_from_packed(maps)
        return superwindow_maps_u16(maps)

    if shadow_maps.shape[0] == 4:
        # Cascade-PARITY table split: the two per-pixel PCF windows hit
        # cascades c and c+1, which always have opposite parity (c=3
        # blends with itself, and blend is False there in both quirk
        # modes). Two half-size superwindow tables (cascades {0,2} and
        # {1,3}, 67 MB each at S=2048) therefore serve the exact same
        # two row gathers as the single 134 MB table, with each gather
        # reading a table half the size (not yet measured on the GPU,
        # ROADMAP S5). Each table is built INDEPENDENTLY from its own
        # cascades' maps so XLA
        # materializes two buffers instead of folding a slice back into
        # one large gather. Bit-exact: every selected PCF value comes
        # from the identical cascade window and projection.
        swin_e = swin_of(shadow_maps[0::2])  # cascades 0, 2
        swin_o = swin_of(shadow_maps[1::2])  # cascades 1, 3
        even = (c & 1) == 0
        ce = jnp.where(even, c, jnp.minimum(c + 1, 2))  # dummy 2 at c=3
        co = jnp.where(even, c + 1, c)
        f_e = poisson_pcf_windowed(swin_e, ce >> 1, shadow_pos_for(ce),
                                   smap_size, soft_radius_texels)
        f_o = poisson_pcf_windowed(swin_o, co >> 1, shadow_pos_for(co),
                                   smap_size, soft_radius_texels)
        f_c = jnp.where(even, f_e, f_o)
        f_n = jnp.where(even, f_o, f_e)  # unused (blend False) when c == 3
    else:
        swin = swin_of(shadow_maps)
        c_next = jnp.minimum(c + 1, 3)
        f_c = poisson_pcf_windowed(swin, c, shadow_pos_for(c), smap_size,
                                   soft_radius_texels)
        f_n = poisson_pcf_windowed(swin, c_next, shadow_pos_for(c_next),
                                   smap_size, soft_radius_texels)

    if deferred_blend_quirk:
        blend = c < 3
    else:
        blend = (c < 3) & (jnp.abs(dist - radii[c]) < 10.0)
    factor = jnp.where(blend, 0.5 * (f_c + f_n), f_c)
    if dead is not None:
        # same contract as the single-tap branch: discarded (sky)
        # receivers get a deterministic 1.0 so the fast path's half-res
        # bilinear upsample never leaks extrapolated factors into
        # silhouette pixels
        factor = jnp.where(dead, 1.0, factor)
    return jnp.where(no_shadow, 1.0, factor)
