"""DirectX-convention math kit.

The reference renderer uses DirectXMath throughout: ROW-VECTOR convention
(``p' = p @ M``), LEFT-HANDED view/projection, NDC depth in [0, 1], and a
y-flip in the NDC->texture matrix. We keep these conventions exactly so the
renderer stays pixel-comparable with the D3D12 reference
(see /root/reference/Common/Camera.cpp:116-129 XMMatrixPerspectiveFovLH,
/root/reference/CRYCHIC.cpp:805-809 the T matrix).

All functions work on numpy arrays (host-side scene math) and are written
so the same code traces under jax.numpy when passed jax arrays (we only use
ops that both implement). Matrices are (4, 4) float32, row-major storage,
row-vector application: ``transform_point(p, M) == [p, 1] @ M``.
"""
from __future__ import annotations

import numpy as np

Array = np.ndarray


# ---------------------------------------------------------------------------
# Vector helpers
# ---------------------------------------------------------------------------

def normalize(v, eps: float = 1e-30):
    """Normalize along the last axis (XMVector3Normalize semantics).

    The default eps only guards the exact-zero vector (scenes without a
    directional light still run cascade fitting on light 0); any real
    direction has |v| >> 1e-30 and divides by its exact norm."""
    np_ = _np_of(v)
    n = np_.sqrt((v * v).sum(axis=-1, keepdims=True))
    if eps:
        n = np_.maximum(n, eps)
    return v / n


def cross(a, b):
    np_ = _np_of(a)
    return np_.cross(a, b)


def dot(a, b):
    return (a * b).sum(axis=-1)


def _np_of(x):
    # Dispatch numpy vs jax.numpy based on array type without importing jax
    # at module load (host-side scene code must not require a device).
    mod = type(x).__module__
    if mod.startswith("jax") or "Tracer" in type(x).__name__:
        import jax.numpy as jnp

        return jnp
    return np


# ---------------------------------------------------------------------------
# Matrix constructors (all row-vector convention, matching DirectXMath)
# ---------------------------------------------------------------------------

def identity4() -> Array:
    return np.eye(4, dtype=np.float32)


def scaling(sx: float, sy: float, sz: float) -> Array:
    """XMMatrixScaling."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def translation(x: float, y: float, z: float) -> Array:
    """XMMatrixTranslation (row-vector: translation in the last row)."""
    m = np.eye(4, dtype=np.float32)
    m[3, 0], m[3, 1], m[3, 2] = x, y, z
    return m


def rotation_x(angle: float) -> Array:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, s
    m[2, 1], m[2, 2] = -s, c
    return m


def rotation_y(angle: float) -> Array:
    """XMMatrixRotationY (row-vector)."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2] = c, -s
    m[2, 0], m[2, 2] = s, c
    return m


def rotation_z(angle: float) -> Array:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, s
    m[1, 0], m[1, 1] = -s, c
    return m


def rotation_axis(axis: Array, angle: float) -> Array:
    """XMMatrixRotationAxis (normalized axis, row-vector convention).

    Rodrigues rotation; sign convention matches DirectXMath (left-handed:
    positive angle = clockwise when viewed from the axis tip toward origin,
    which for row vectors gives the matrix below).
    """
    a = normalize(np.asarray(axis, dtype=np.float32))
    x, y, z = float(a[0]), float(a[1]), float(a[2])
    c, s = float(np.cos(angle)), float(np.sin(angle))
    t = 1.0 - c
    m = np.array(
        [
            [t * x * x + c, t * x * y + s * z, t * x * z - s * y, 0.0],
            [t * x * y - s * z, t * y * y + c, t * y * z + s * x, 0.0],
            [t * x * z + s * y, t * y * z - s * x, t * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )
    return m


def perspective_fov_lh(fov_y: float, aspect: float, zn: float, zf: float) -> Array:
    """XMMatrixPerspectiveFovLH — left-handed, NDC z in [0, 1].

    Reference use: Common/Camera.cpp:127.
    Row-vector form:
        [w 0 0         0]
        [0 h 0         0]
        [0 0 zf/(zf-zn) 1]
        [0 0 -zn*zf/(zf-zn) 0]
    with h = cot(fovY/2), w = h / aspect.
    """
    h = 1.0 / np.tan(0.5 * fov_y)
    w = h / aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = zf / (zf - zn)
    m[2, 3] = 1.0
    m[3, 2] = -zn * zf / (zf - zn)
    return m


def ortho_off_center_lh(l: float, r: float, b: float, t: float, zn: float, zf: float) -> Array:
    """XMMatrixOrthographicOffCenterLH — reference use: CRYCHIC.cpp:804."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / (r - l)
    m[1, 1] = 2.0 / (t - b)
    m[2, 2] = 1.0 / (zf - zn)
    m[3, 0] = (l + r) / (l - r)
    m[3, 1] = (t + b) / (b - t)
    m[3, 2] = zn / (zn - zf)
    m[3, 3] = 1.0
    return m


def look_at_lh(eye, target, up) -> Array:
    """XMMatrixLookAtLH — reference use: CRYCHIC.cpp:734."""
    eye = np.asarray(eye, dtype=np.float32)[:3]
    target = np.asarray(target, dtype=np.float32)[:3]
    up = np.asarray(up, dtype=np.float32)[:3]
    z = normalize(target - eye)
    x = normalize(np.cross(up, z))
    y = np.cross(z, x)
    m = np.array(
        [
            [x[0], y[0], z[0], 0.0],
            [x[1], y[1], z[1], 0.0],
            [x[2], y[2], z[2], 0.0],
            [-np.dot(x, eye), -np.dot(y, eye), -np.dot(z, eye), 1.0],
        ],
        dtype=np.float32,
    )
    return m


def ndc_to_tex() -> Array:
    """The T matrix: NDC [-1,1]^2 -> texture space [0,1]^2 with a y flip.

    Reference: CRYCHIC.cpp:805-809 / :828-832.
    """
    return np.array(
        [
            [0.5, 0.0, 0.0, 0.0],
            [0.0, -0.5, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [0.5, 0.5, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def inverse_transpose(m: Array) -> Array:
    """MathHelper::InverseTranspose (MathHelper.h:69): zeroes the
    translation row before inverting so normals are unaffected by it."""
    a = np.array(m, dtype=np.float32)
    a[3, :] = [0.0, 0.0, 0.0, 1.0]
    return np.linalg.inv(a).T.astype(np.float32)


def spherical_to_cartesian(radius: float, theta: float, phi: float) -> Array:
    """MathHelper::SphericalToCartesian (left-handed y-up)."""
    return np.array(
        [radius * np.sin(phi) * np.cos(theta),
         radius * np.cos(phi),
         radius * np.sin(phi) * np.sin(theta)], dtype=np.float32)


def angle_from_xy(x: float, y: float) -> float:
    """MathHelper::AngleFromXY (MathHelper.cpp:14): polar angle in [0, 2pi)."""
    if x >= 0.0:
        theta = float(np.arctan(y / x)) if x != 0 else (
            np.pi / 2 if y > 0 else 3 * np.pi / 2)
        if theta < 0.0:
            theta += 2.0 * np.pi
    else:
        theta = float(np.arctan(y / x)) + np.pi
    return theta


def inverse(m: Array) -> Array:
    np_ = _np_of(m)
    if np_ is np:
        return np.linalg.inv(m).astype(np.float32)
    import jax.numpy as jnp

    return jnp.linalg.inv(m)


# ---------------------------------------------------------------------------
# Transform application (row-vector)
# ---------------------------------------------------------------------------

def transform_point(p, m):
    """[p, 1] @ m, returning the full homogeneous (..., 4) result."""
    np_ = _np_of(p)
    ones = np_.ones(p.shape[:-1] + (1,), dtype=p.dtype)
    ph = np_.concatenate([p, ones], axis=-1)
    return ph @ m


def transform_coord(p, m):
    """XMVector3TransformCoord: [p,1] @ m then divide by w."""
    r = transform_point(p, m)
    return r[..., :3] / r[..., 3:4]


def transform_normal(n, m):
    """XMVector3TransformNormal: n @ upper-left 3x3 of m (no translation)."""
    return n @ m[..., :3, :3]
