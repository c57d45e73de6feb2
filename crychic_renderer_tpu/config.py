"""Render configuration.

Replaces the reference's compile-time constants (gNumFrameResources,
shadow resolution, cascade radii, blur count, deferred/culling toggles —
/root/reference/CRYCHIC.h:20-21,188-189, CRYCHIC.cpp:49,221) with one
dataclass. Fields marked static shape the compiled XLA program.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1920
    height: int = 1080
    shadow_map_size: int = 2048  # reference builds 4096 (CRYCHIC.cpp:49);
    # BASELINE.json's graded configs specify 2048^2
    num_cascades: int = 4
    ssao_enabled: bool = True
    ssao_blur_count: int = 3  # CRYCHIC.cpp:221
    shadows_enabled: bool = True
    deferred: bool = True  # CRYCHIC.h:189 isDeferred
    frustum_culling: bool = True  # CRYCHIC.h:188
    sky_enabled: bool = True
    # rasterizer sizing (static): capacity of the pair expansion and the
    # per-tile bin. Oversize for safety; overflow is reported by bin stats.
    pair_capacity: int = 1 << 19
    bin_cap: int = 1024
    shadow_pair_capacity: int = 1 << 19
    shadow_bin_cap: int = 512
    # lighting config (shader #defines in the reference)
    num_dir_lights: int = 3
    num_point_lights: int = 0
    num_spot_lights: int = 0
    use_pbr: bool = True  # PBRShading vs ComputeLighting (Default.hlsl:163-165)
    # max anisotropy for material texture sampling; the reference's static
    # samplers use D3D12_FILTER_ANISOTROPIC with MaxAnisotropy=8
    # (CRYCHIC.cpp:2631-2645). 1 = trilinear.
    anisotropy: int = 8
    # static probe count for the aniso sampler (gathers per pixel); probes
    # alternate mip levels, so 4 probes = the cost of plain trilinear of
    # two textures while covering an 8:1 footprint (see sample_pair_aniso).
    # With dual_mip_rows each probe is a full trilinear from ONE gather:
    # 2 dual probes match the legacy 4 alternating-mip probes in PSNR
    # against the 8-probe reference-quality evaluator at HALF the row
    # gathers; 4 dual probes are the high-quality option
    aniso_probes: int = 2
    # rasterizer: True = the Pallas kernel (ops.raster_pallas, GPU), False
    # = the XLA reference (ops.rasterizer.rasterize_binned), None = chosen
    # by the backend (raster_pallas.kernel_for_backend)
    use_pallas: bool | None = None
    # alpha-tested geometry (the reference's ALPHA_TEST shader variants,
    # Default.hlsl clip(diffuseAlbedo.a - 0.1), Shadows.hlsl:49-65).
    # Design: small-N dense rasterization with k depth peels — the
    # nearest fragment whose sampled alpha passes wins (see
    # passes.frame.alpha-test section). Off unless the scene carries an
    # alpha layer.
    alpha_test_enabled: bool = False
    alpha_peels: int = 2          # depth-peel iterations (clip recovery)
    alpha_clip: float = 0.1       # clip threshold (Default.hlsl:106)
    alpha_shadow_window: int = 512  # static light-space window per cascade
    # run the kernel in the Pallas interpreter (CPU tests only; Renderer
    # refuses it on the GPU)
    pallas_interpret: bool = False
    # debug views: None | "shadow_cascade3" (the reference's ShadowDebug.hlsl
    # quad) | "cascades" (the commented-out colorization, Default.hlsl:152)
    debug_view: str = None
    # the sky is the PROCEDURAL substitute (the reference's snowcube1024.dds
    # asset is missing, SURVEY.md §0): evaluate it analytically — zero
    # gathers, strictly less quantization than sampling the baked cubemap.
    # False = gather from DeviceScene.cubemap (file-loaded cubemaps).
    procedural_sky: bool = True
    # Poisson PCF disk radius in texels. None = the radius the reference
    # COMPILES to: `5 / width / 2.0f` (Common.hlsl:301) is an int/uint
    # division, i.e. 0.0 — all 16 taps coincide, one bilinear comparison
    # tap (ops.shadows.compiled_poisson_radius_uv; verified against the
    # scalar HLSL transliteration in tests/test_hlsl_oracle.py). 2.5
    # restores the soft disk the author evidently INTENDED (the float
    # value of 5/width/2 texels) — an enhancement, not parity.
    pcf_radius_texels: float = None
    # texture pool layout: dual-mip rows pack mip m AND its m+1 parent
    # quads in one 16-lane row, so a trilinear sample and EVERY aniso
    # probe pay ONE row gather instead of two, at 2x pool bytes
    # (ops.sampling.PairPool docstring; its cost on the GPU is not yet
    # measured, ROADMAP S5)
    dual_mip_rows: bool = True
    # performance knobs (defaults keep reference parity):
    # compute the cascade PCF factor at half resolution + bilinear upsample
    fast_shadow_factor: bool = False
    # SSAO resolution divisor (2 = the reference's half-res)
    ssao_scale: int = 2
    # Tile-compacted shading: per-pixel resolve gathers (records + texture
    # probes) are issued only for (8, 128) pixel tiles containing at least
    # one covered pixel, so sparsely covered frames (config 2: a skull on
    # sky) do not spend their resolve on discarded sky rows
    # (passes.frame._resolve_compacted; not yet measured on the GPU,
    # ROADMAP S5).
    # None = full-screen resolve; Renderer autosizing sets this from the
    # exact occupied-tile bound with the same check_capacity guard as the
    # pair capacities.
    shade_tile_capacity: int = None
    # Tile-compacted SSAO occlusion: the 14 tap gathers are issued only
    # for (8, 32) HALF-res tiles within the blur/upsample support of a
    # covered pixel — bit-exact on the full access map (skipped sky
    # tiles' true occlusion is exactly 1.0; see
    # passes.frame._ssao_occlusion_compacted). None = full-grid
    # occlusion; Renderer autosizing sets it like shade_tile_capacity.
    ssao_tile_capacity: int = None
    # Multi-chip band binning capacities (pairs per DEVICE band). None =
    # the full-frame capacities (always safe). Pair counts are heavily
    # skewed across bands — the horizon band of the cascade scene holds
    # 70-90% of the frame's main-view pairs — so do not guess a 1/n_dev
    # split; size these from parallel.sharded.band_requirements (see
    # autosize_band_capacities).
    band_pair_capacity: int = None
    shadow_band_pair_capacity: int = None

    @property
    def ssao_width(self):
        return self.width // self.ssao_scale

    def fast_preset(self) -> "RenderConfig":
        """The documented --fast performance preset: half-res PCF factor
        + bilinear upsample, quarter-res SSAO, and trilinear texturing
        (one dual-mip gather instead of per-probe anisotropy). Its image
        is pinned by committed fast goldens (tests/goldens/). ONE
        definition — the viewer and the CLI both call this."""
        return dataclasses.replace(self, fast_shadow_factor=True,
                                   ssao_scale=4, anisotropy=1)

    @property
    def ssao_height(self):
        return self.height // self.ssao_scale
