"""CRYCHIC: a real-time software renderer built on JAX/XLA/Pallas.

A from-scratch re-design of the capabilities of the D3D12 renderer
``UnlimitedRainWorks/CRYCHIC-RENDERER`` (deferred shading, cascaded shadow
maps, SSAO, Cook-Torrance PBR, GPU instancing + frustum culling, sky cubemap)
as a purely functional frame pipeline:

    frame(scene, camera, time) -> image

with the rasterization pipeline (vertex transform, tile binning, depth
test) implemented as a tile-based visibility-buffer rasterizer and each
screen-space pass a fused kernel over pixel tiles.

Layers (bottom-up), mirroring the reference's layer map (SURVEY.md §1):

- ``utils``    — DirectX-convention math kit (row-vector, left-handed,
                 NDC z in [0,1]); MSVC rand replication for seed parity.
- ``io``       — asset pipeline: DDS parser + BC1/BC3 decode, Models/*.txt
                 mesh loader (reference: Common/DDSTextureLoader.cpp,
                 CRYCHIC.cpp:1447 BuildSkullGeometry).
- ``models``   — procedural geometry, cameras, materials, lights, scenes
                 (reference: Common/GeometryGenerator.cpp, Common/Camera.cpp,
                 CRYCHIC.cpp BuildMaterials/Build*RenderItems).
- ``ops``      — device kernels: rasterizer, texture sampling, SSAO,
                 bilateral blur, PBR shading, PCF (reference: Shaders/*.hlsl
                 + the D3D12 rasterizer hardware itself).
- ``passes``   — render passes composed into ``render_frame`` in the exact
                 order of CRYCHIC::Draw (CRYCHIC.cpp:172-436).
- ``parallel`` — multi-device sharding of the frame over a
                 jax.sharding.Mesh (screen-tile data parallelism + cascade
                 parallelism).
- ``app``      — frame loop, config, stats (reference: Common/d3dApp.cpp).
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry correctness: the vertex, clip and cascade transforms are f32
# matrix products, and on an NVIDIA GPU a DEFAULT-precision f32 product
# may run in TF32 on the tensor cores (10 mantissa bits, vertex errors of
# a fraction of a pixel at 1080p). A renderer's transforms are
# precision-critical end to end (the rasterizer snaps to 1/256 pixel), so
# the package pins full-f32 matmul semantics globally; the products are
# tiny and the raster kernel has none.
_jax.config.update("jax_default_matmul_precision", "float32")
