"""SE(2) geometry primitives as pure JAX functions.

The reference uses Sophus::SE2d plus a scalar (x, y, theta) representation
side by side (``RS/include/ndt_slam/trajectory_representation.h:12-22``).
This build uses a single ``(..., 3)`` array ``[x, y, theta]`` everywhere;
batched ops broadcast over leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_angle(theta):
    """Wrap angle to (-pi, pi].

    Matches ``NormalizeAngle`` (``RS/include/ndt_registration/state_manifold.h:17-23``),
    implemented branch-free for tracing.
    """
    two_pi = 2.0 * jnp.pi
    return theta - two_pi * jnp.floor((theta + jnp.pi) / two_pi)


def rotmat(theta):
    """2x2 rotation matrix; broadcasts: theta (...) -> (..., 2, 2)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def compose(a, b):
    """SE(2) composition a*b for pose arrays (..., 3)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = normalize_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, th], axis=-1)


def inverse(a):
    """SE(2) inverse for pose arrays (..., 3)."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return jnp.stack([x, y, normalize_angle(-a[..., 2])], axis=-1)


def relative(a, b):
    """a^{-1} * b."""
    return compose(inverse(a), b)


def transform_points(pose, pts):
    """Apply pose (..., 3) to 2-D points (..., N, 2)."""
    R = rotmat(pose[..., 2])
    return jnp.einsum("...ij,...nj->...ni", R, pts) + pose[..., None, :2]


def exp(tangent):
    """SE(2) exponential map from twist (..., 3) = [vx, vy, omega].

    Matches Sophus::SE2::exp; used by the reference's manifold variant
    (``ceres_residuals.h:74-77``).
    """
    vx, vy, w = tangent[..., 0], tangent[..., 1], tangent[..., 2]
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    sin_w, cos_w = jnp.sin(w_safe), jnp.cos(w_safe)
    a = jnp.where(small, 1.0 - w * w / 6.0, sin_w / w_safe)
    b = jnp.where(small, w / 2.0 - w**3 / 24.0, (1.0 - cos_w) / w_safe)
    x = a * vx - b * vy
    y = b * vx + a * vy
    return jnp.stack([x, y, normalize_angle(w)], axis=-1)


def log(pose):
    """SE(2) logarithm to twist (..., 3)."""
    x, y, th = pose[..., 0], pose[..., 1], normalize_angle(pose[..., 2])
    small = jnp.abs(th) < 1e-6
    th_safe = jnp.where(small, 1.0, th)
    half = 0.5 * th_safe
    # V^{-1} coefficients
    a = jnp.where(small, 1.0 - th * th / 12.0, half / jnp.tan(half))
    vx = a * x + 0.5 * th * y
    vy = -0.5 * th * x + a * y
    return jnp.stack([vx, vy, th], axis=-1)


def pose_matrix(pose):
    """Homogeneous 3x3 matrix of pose (..., 3)."""
    R = rotmat(pose[..., 2])
    t = pose[..., :2]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=pose.dtype), top.shape[:-2] + (1, 3)
    )
    return jnp.concatenate([top, bottom], axis=-2)
