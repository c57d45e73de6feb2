"""Procedural mesh generation.

A struct-of-arrays re-implementation of the reference's GeometryGenerator
(/root/reference/Common/GeometryGenerator.cpp): box (24v/36i + subdivision),
UV sphere, geosphere (icosahedron subdivision), cylinder with caps, grid,
NDC quad. Vertex attribute math is replicated exactly (same vertex order,
same index winding, same tangent derivations) so meshes are bit-comparable
with the reference and golden tests stay meaningful.

Unlike the reference's array-of-structs ``std::vector<Vertex>``, meshes here
are numpy struct-of-arrays — the natural layout for batched device math
(positions (N,3) batch into (N,4)x(4,4) products without interleaving).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Struct-of-arrays mesh. float32 / int32 throughout."""

    positions: np.ndarray  # (N, 3)
    normals: np.ndarray  # (N, 3)
    tangents: np.ndarray  # (N, 3)
    uvs: np.ndarray  # (N, 2)
    indices: np.ndarray  # (M,) int32, triangle list

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0] // 3

    def aabb(self):
        """(center, extents) bounding box — reference: CRYCHIC.cpp:1334-1337."""
        vmin = self.positions.min(axis=0)
        vmax = self.positions.max(axis=0)
        return 0.5 * (vmin + vmax), 0.5 * (vmax - vmin)


def _mesh(verts_rows, indices) -> MeshData:
    """verts_rows: list of 11-tuples (px,py,pz, nx,ny,nz, tx,ty,tz, u,v)."""
    v = np.asarray(verts_rows, dtype=np.float32).reshape(-1, 11)
    return MeshData(
        positions=v[:, 0:3].copy(),
        normals=v[:, 3:6].copy(),
        tangents=v[:, 6:9].copy(),
        uvs=v[:, 9:11].copy(),
        indices=np.asarray(indices, dtype=np.int32),
    )


def _normalize_rows(a: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return (a / np.maximum(n, 1e-30)).astype(np.float32)


def create_box(width: float, height: float, depth: float, num_subdivisions: int = 0) -> MeshData:
    """GeometryGenerator::CreateBox (GeometryGenerator.cpp:10-101)."""
    w2, h2, d2 = 0.5 * width, 0.5 * height, 0.5 * depth
    V = [
        # front face
        (-w2, -h2, -d2, 0, 0, -1, 1, 0, 0, 0, 1),
        (-w2, +h2, -d2, 0, 0, -1, 1, 0, 0, 0, 0),
        (+w2, +h2, -d2, 0, 0, -1, 1, 0, 0, 1, 0),
        (+w2, -h2, -d2, 0, 0, -1, 1, 0, 0, 1, 1),
        # back face
        (-w2, -h2, +d2, 0, 0, 1, -1, 0, 0, 1, 1),
        (+w2, -h2, +d2, 0, 0, 1, -1, 0, 0, 0, 1),
        (+w2, +h2, +d2, 0, 0, 1, -1, 0, 0, 0, 0),
        (-w2, +h2, +d2, 0, 0, 1, -1, 0, 0, 1, 0),
        # top face
        (-w2, +h2, -d2, 0, 1, 0, 1, 0, 0, 0, 1),
        (-w2, +h2, +d2, 0, 1, 0, 1, 0, 0, 0, 0),
        (+w2, +h2, +d2, 0, 1, 0, 1, 0, 0, 1, 0),
        (+w2, +h2, -d2, 0, 1, 0, 1, 0, 0, 1, 1),
        # bottom face
        (-w2, -h2, -d2, 0, -1, 0, -1, 0, 0, 1, 1),
        (+w2, -h2, -d2, 0, -1, 0, -1, 0, 0, 0, 1),
        (+w2, -h2, +d2, 0, -1, 0, -1, 0, 0, 0, 0),
        (-w2, -h2, +d2, 0, -1, 0, -1, 0, 0, 1, 0),
        # left face
        (-w2, -h2, +d2, -1, 0, 0, 0, 0, -1, 0, 1),
        (-w2, +h2, +d2, -1, 0, 0, 0, 0, -1, 0, 0),
        (-w2, +h2, -d2, -1, 0, 0, 0, 0, -1, 1, 0),
        (-w2, -h2, -d2, -1, 0, 0, 0, 0, -1, 1, 1),
        # right face
        (+w2, -h2, -d2, 1, 0, 0, 0, 0, 1, 0, 1),
        (+w2, +h2, -d2, 1, 0, 0, 0, 0, 1, 0, 0),
        (+w2, +h2, +d2, 1, 0, 0, 0, 0, 1, 1, 0),
        (+w2, -h2, +d2, 1, 0, 0, 0, 0, 1, 1, 1),
    ]
    I = [
        0, 1, 2, 0, 2, 3,
        4, 5, 6, 4, 6, 7,
        8, 9, 10, 8, 10, 11,
        12, 13, 14, 12, 14, 15,
        16, 17, 18, 16, 18, 19,
        20, 21, 22, 20, 22, 23,
    ]
    mesh = _mesh(V, I)
    for _ in range(min(int(num_subdivisions), 6)):
        mesh = subdivide(mesh)
    return mesh


def subdivide(mesh: MeshData) -> MeshData:
    """GeometryGenerator::Subdivide (GeometryGenerator.cpp:214-275).

    Each triangle becomes 4; vertices are fully duplicated per source
    triangle in the reference's order: [v0 v1 v2 m0 m1 m2] with triangles
    (0,3,5) (3,4,5) (5,4,2) (3,1,4).
    """
    idx = mesh.indices.reshape(-1, 3)
    v0, v1, v2 = idx[:, 0], idx[:, 1], idx[:, 2]

    def mid(attr, a, b, renorm):
        m = 0.5 * (attr[a] + attr[b])
        if renorm:
            m = _normalize_rows(m)
        return m.astype(np.float32)

    P, N, T, UV = mesh.positions, mesh.normals, mesh.tangents, mesh.uvs
    # per-triangle vertex rows in order [v0, v1, v2, m0(v0,v1), m1(v1,v2), m2(v0,v2)]
    def stack6(attr, renorm):
        rows = [
            attr[v0],
            attr[v1],
            attr[v2],
            mid(attr, v0, v1, renorm),
            mid(attr, v1, v2, renorm),
            mid(attr, v0, v2, renorm),
        ]
        # (T, 6, C) then flatten
        return np.stack(rows, axis=1).reshape(-1, attr.shape[1]).astype(np.float32)

    new_p = stack6(P, False)
    new_n = stack6(N, True)
    new_t = stack6(T, True)
    new_uv = stack6(UV, False)

    ntri = idx.shape[0]
    base = (np.arange(ntri, dtype=np.int32) * 6)[:, None]
    pattern = np.array([0, 3, 5, 3, 4, 5, 5, 4, 2, 3, 1, 4], dtype=np.int32)[None, :]
    new_idx = (base + pattern).reshape(-1)
    return MeshData(new_p, new_n, new_t, new_uv, new_idx)


def create_sphere(radius: float, slice_count: int, stack_count: int) -> MeshData:
    """GeometryGenerator::CreateSphere (GeometryGenerator.cpp:103-212)."""
    verts = [(0.0, radius, 0.0, 0, 1, 0, 1, 0, 0, 0, 0)]
    phi_step = np.pi / stack_count
    theta_step = 2.0 * np.pi / slice_count
    for i in range(1, stack_count):
        phi = i * phi_step
        for j in range(slice_count + 1):
            theta = j * theta_step
            sp, cp = np.sin(phi), np.cos(phi)
            st, ct = np.sin(theta), np.cos(theta)
            p = (radius * sp * ct, radius * cp, radius * sp * st)
            t = np.array([-radius * sp * st, 0.0, radius * sp * ct], dtype=np.float32)
            t /= np.linalg.norm(t)
            n = np.array(p, dtype=np.float32)
            n /= np.linalg.norm(n)
            verts.append(
                (p[0], p[1], p[2], n[0], n[1], n[2], t[0], t[1], t[2],
                 theta / (2.0 * np.pi), phi / np.pi)
            )
    verts.append((0.0, -radius, 0.0, 0, -1, 0, 1, 0, 0, 0, 1))

    idx = []
    for i in range(1, slice_count + 1):
        idx += [0, i + 1, i]
    base = 1
    ring = slice_count + 1
    for i in range(stack_count - 2):
        for j in range(slice_count):
            idx += [
                base + i * ring + j,
                base + i * ring + j + 1,
                base + (i + 1) * ring + j,
                base + (i + 1) * ring + j,
                base + i * ring + j + 1,
                base + (i + 1) * ring + j + 1,
            ]
    south = len(verts) - 1
    base = south - ring
    for i in range(slice_count):
        idx += [south, base + i, base + i + 1]
    return _mesh(verts, idx)


def create_geosphere(radius: float, num_subdivisions: int) -> MeshData:
    """GeometryGenerator::CreateGeosphere (GeometryGenerator.cpp:307-380)."""
    X, Z = 0.525731, 0.850651
    pos = np.array(
        [
            [-X, 0, Z], [X, 0, Z], [-X, 0, -Z], [X, 0, -Z],
            [0, Z, X], [0, Z, -X], [0, -Z, X], [0, -Z, -X],
            [Z, X, 0], [-Z, X, 0], [Z, -X, 0], [-Z, -X, 0],
        ],
        dtype=np.float32,
    )
    k = np.array(
        [
            1, 4, 0, 4, 9, 0, 4, 5, 9, 8, 5, 4, 1, 8, 4,
            1, 10, 8, 10, 3, 8, 8, 3, 5, 3, 2, 5, 3, 7, 2,
            3, 10, 7, 10, 6, 7, 6, 11, 7, 6, 0, 11, 6, 1, 0,
            10, 1, 6, 11, 0, 9, 2, 11, 9, 5, 2, 9, 11, 2, 7,
        ],
        dtype=np.int32,
    )
    zeros3 = np.zeros_like(pos)
    zeros2 = np.zeros((pos.shape[0], 2), dtype=np.float32)
    mesh = MeshData(pos, zeros3.copy(), zeros3.copy(), zeros2, k)
    for _ in range(min(int(num_subdivisions), 6)):
        mesh = subdivide(mesh)

    n = _normalize_rows(mesh.positions)
    p = (radius * n).astype(np.float32)
    theta = np.arctan2(p[:, 2], p[:, 0])
    theta = np.where(theta < 0.0, theta + 2.0 * np.pi, theta)
    phi = np.arccos(np.clip(p[:, 1] / radius, -1.0, 1.0))
    uv = np.stack([theta / (2.0 * np.pi), phi / np.pi], axis=-1).astype(np.float32)
    tang = np.stack(
        [-radius * np.sin(phi) * np.sin(theta),
         np.zeros_like(theta),
         radius * np.sin(phi) * np.cos(theta)],
        axis=-1,
    )
    # guard poles where the tangent degenerates to zero length
    tlen = np.linalg.norm(tang, axis=-1, keepdims=True)
    tang = np.where(tlen > 1e-20, tang / np.maximum(tlen, 1e-20), np.array([1.0, 0, 0]))
    return MeshData(p, n, tang.astype(np.float32), uv, mesh.indices)


def create_cylinder(bottom_radius: float, top_radius: float, height: float,
                    slice_count: int, stack_count: int) -> MeshData:
    """GeometryGenerator::CreateCylinder (GeometryGenerator.cpp:382-549)."""
    verts, idx = [], []
    stack_height = height / stack_count
    radius_step = (top_radius - bottom_radius) / stack_count
    d_theta = 2.0 * np.pi / slice_count
    for i in range(stack_count + 1):
        y = -0.5 * height + i * stack_height
        r = bottom_radius + i * radius_step
        for j in range(slice_count + 1):
            c, s = np.cos(j * d_theta), np.sin(j * d_theta)
            t = np.array([-s, 0.0, c])
            dr = bottom_radius - top_radius
            bit = np.array([dr * c, -height, dr * s])
            n = np.cross(t, bit)
            n /= np.linalg.norm(n)
            verts.append(
                (r * c, y, r * s, n[0], n[1], n[2], t[0], t[1], t[2],
                 j / slice_count, 1.0 - i / stack_count)
            )
    ring = slice_count + 1
    for i in range(stack_count):
        for j in range(slice_count):
            idx += [
                i * ring + j, (i + 1) * ring + j, (i + 1) * ring + j + 1,
                i * ring + j, (i + 1) * ring + j + 1, i * ring + j + 1,
            ]
    # top cap
    base = len(verts)
    y = 0.5 * height
    for i in range(slice_count + 1):
        x = top_radius * np.cos(i * d_theta)
        z = top_radius * np.sin(i * d_theta)
        verts.append((x, y, z, 0, 1, 0, 1, 0, 0, x / height + 0.5, z / height + 0.5))
    verts.append((0, y, 0, 0, 1, 0, 1, 0, 0, 0.5, 0.5))
    center = len(verts) - 1
    for i in range(slice_count):
        idx += [center, base + i + 1, base + i]
    # bottom cap
    base = len(verts)
    y = -0.5 * height
    for i in range(slice_count + 1):
        x = bottom_radius * np.cos(i * d_theta)
        z = bottom_radius * np.sin(i * d_theta)
        verts.append((x, y, z, 0, -1, 0, 1, 0, 0, x / height + 0.5, z / height + 0.5))
    verts.append((0, y, 0, 0, -1, 0, 1, 0, 0, 0.5, 0.5))
    center = len(verts) - 1
    for i in range(slice_count):
        idx += [center, base + i, base + i + 1]
    return _mesh(verts, idx)


def create_grid(width: float, depth: float, m: int, n: int) -> MeshData:
    """GeometryGenerator::CreateGrid (GeometryGenerator.cpp:551-614)."""
    half_w, half_d = 0.5 * width, 0.5 * depth
    dx, dz = width / (n - 1), depth / (m - 1)
    du, dv = 1.0 / (n - 1), 1.0 / (m - 1)
    ii, jj = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    x = -half_w + jj * dx
    z = half_d - ii * dz
    pos = np.stack([x, np.zeros_like(x), z], axis=-1).reshape(-1, 3).astype(np.float32)
    nrm = np.tile(np.array([0, 1, 0], dtype=np.float32), (m * n, 1))
    tan = np.tile(np.array([1, 0, 0], dtype=np.float32), (m * n, 1))
    uv = np.stack([jj * du, ii * dv], axis=-1).reshape(-1, 2).astype(np.float32)

    qi, qj = np.meshgrid(np.arange(m - 1), np.arange(n - 1), indexing="ij")
    a = (qi * n + qj).reshape(-1)
    idx = np.stack(
        [a, a + 1, a + n, a + n, a + 1, a + n + 1], axis=-1
    ).reshape(-1).astype(np.int32)
    return MeshData(pos, nrm, tan, uv, idx)


def create_quad(x: float, y: float, w: float, h: float, depth: float) -> MeshData:
    """GeometryGenerator::CreateQuad (GeometryGenerator.cpp:616-657).

    Positions are in NDC space (used for the shadow-debug overlay quad).
    """
    V = [
        (x, y - h, depth, 0, 0, -1, 1, 0, 0, 0, 1),
        (x, y, depth, 0, 0, -1, 1, 0, 0, 0, 0),
        (x + w, y, depth, 0, 0, -1, 1, 0, 0, 1, 0),
        (x + w, y - h, depth, 0, 0, -1, 1, 0, 0, 1, 1),
    ]
    return _mesh(V, [0, 1, 2, 0, 2, 3])


def concat_meshes(meshes):
    """Concatenate into one vertex/index buffer, returning (MeshData, submesh
    table) — the reference's BuildShapeGeometry pattern (CRYCHIC.cpp:1250).

    Each submesh entry: dict(index_count, start_index, base_vertex,
    bounds_center, bounds_extents).
    """
    subs = []
    v_off = 0
    i_off = 0
    for mesh in meshes:
        c, e = mesh.aabb()
        subs.append(
            dict(
                index_count=mesh.indices.shape[0],
                start_index=i_off,
                base_vertex=v_off,
                bounds_center=c,
                bounds_extents=e,
            )
        )
        v_off += mesh.num_vertices
        i_off += mesh.indices.shape[0]
    big = MeshData(
        positions=np.concatenate([m.positions for m in meshes], axis=0),
        normals=np.concatenate([m.normals for m in meshes], axis=0),
        tangents=np.concatenate([m.tangents for m in meshes], axis=0),
        uvs=np.concatenate([m.uvs for m in meshes], axis=0),
        indices=np.concatenate(
            [m.indices + s["base_vertex"] for m, s in zip(meshes, subs)], axis=0
        ),
    )
    return big, subs
