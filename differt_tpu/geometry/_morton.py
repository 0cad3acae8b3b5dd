"""Morton (Z-order) sorting of 3D points."""

import jax.numpy as jnp

from .._typing import Array, Float, Int


def morton_perm_points(
    points: Float[Array, "num_points 3"],
) -> Int[Array, " num_points"]:
    """Permutation sorting 3D points along a Morton (Z-order) curve.

    Spatially-adjacent points land next to each other, which makes
    fixed-size chunks of the sorted order spatially compact: the ray-casting
    kernels cull whole chunks of Morton-sorted triangles with one box test,
    and the coverage map tiles Morton-sorted receivers into compact blocks.

    >>> import jax.numpy as jnp
    >>> pts = jnp.array(
    ...     [[0.0, 0.0, 0.0], [9.0, 9.0, 9.0], [0.1, 0.0, 0.0], [9.0, 8.9, 9.0]]
    ... )
    >>> perm = morton_perm_points(pts)
    >>> sorted_pts = pts[perm]  # near points become neighbors
    >>> bool(jnp.linalg.norm(sorted_pts[0] - sorted_pts[1]) < 1.0)
    True
    >>> bool(jnp.linalg.norm(sorted_pts[2] - sorted_pts[3]) < 1.0)
    True
    """
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = jnp.where(hi > lo, hi - lo, 1.0)
    q = ((points - lo) / extent * 1023.0).astype(jnp.uint32).clip(0, 1023)

    def part1by2(x):
        x = x & jnp.uint32(0x3FF)
        x = (x | (x << 16)) & jnp.uint32(0x030000FF)
        x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
        x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
        x = (x | (x << 2)) & jnp.uint32(0x09249249)
        return x

    code = (
        part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1) | (part1by2(q[:, 2]) << 2)
    )
    return jnp.argsort(code).astype(jnp.int32)
