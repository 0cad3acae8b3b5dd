"""Memory-bounded scans over all scene triangles (pure JAX).

These implement occlusion (any-hit), closest-hit, and visibility estimation
with peak memory bounded at ``batch * tile_size``, by padding the scanned
axis to a whole number of tiles and reducing the tiles with a ``lax.scan``
(one static-shape slice per step — no dynamic slicing, no separate
remainder pass; padded entries are simply deactivated).

Reference parity (same contracts, different tiling design — the reference
uses a ``fori_loop`` over dynamic slices plus a remainder epilogue):
``ray_intersect_any_triangle`` (_utils.py:1325-1537),
``first_triangle_hit_by_ray`` (_utils.py:1775-1961), and
``triangles_visible_from_vertex`` (_utils.py:1540-1772). The Pallas
kernels in :mod:`differt_tpu.ops` implement the first two contracts on a
GPU; these pure-JAX versions are the portable backend and the
correctness references.
"""

from typing import Any, Callable

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, Float, Int

from ..geometry._lattice import fibonacci_lattice, viewing_frustum
from ..utils import smoothing_function
from ._triangle import ray_intersect_triangle


def _into_tiles(
    x: Array, axis: int, tile_size: int, fill: ArrayLike
) -> tuple[Array, int]:
    """Pad ``axis`` up to a tile multiple and split it into leading tiles.

    Returns ``(tiles, num_tiles)`` where ``tiles`` has the tile index as
    axis 0 and ``tile_size`` entries along the original (now static-shape)
    axis; padded entries hold ``fill``.
    """
    axis = axis % x.ndim
    total = x.shape[axis]
    num_tiles = -(-total // tile_size)
    pad = num_tiles * tile_size - total
    if pad:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        x = jnp.pad(x, widths, constant_values=fill)
    split = x.reshape(
        *x.shape[:axis], num_tiles, tile_size, *x.shape[axis + 1 :]
    )
    return jnp.moveaxis(split, axis, 0), num_tiles


def _scan_reduce(
    tile_fn: Callable[..., Any],
    combine: Callable[[Any, Any], Any],
    init: Any,
    xs: tuple[Array, ...],
) -> Any:
    """Fold ``tile_fn`` over stacked tiles with a ``lax.scan``."""

    def step(acc: Any, tiles: tuple[Array, ...]) -> tuple[Any, None]:
        return combine(acc, tile_fn(*tiles)), None

    acc, _ = jax.lax.scan(step, init, xs)
    return acc


def _clamp_tile(total: int, tile_size: int | None) -> int:
    if tile_size is None:
        return total
    return max(min(tile_size, total), 1)


def ray_intersect_any_triangle(
    ray_origins: Float[ArrayLike, "*#batch 3"],
    ray_directions: Float[ArrayLike, "*#batch 3"],
    triangle_vertices: Float[ArrayLike, "*#batch num_triangles 3 3"],
    active_triangles: Bool[ArrayLike, "*#batch num_triangles"] | None = None,
    *,
    hit_tol: Float[ArrayLike, ""] | None = None,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
    batch_size: int | None = 512,
    **kwargs: Any,
) -> Bool[Array, " *batch"] | Float[Array, " *batch"]:
    """Whether each ray hits *any* triangle before ``t = 1 - hit_tol``.

    A triangle counts as blocking when ``(t < 1 - hit_tol) & hit``. With
    ``smoothing_factor``, returns a clipped sum of per-triangle confidences.
    ``hit_tol`` defaults to ``100 * eps(dtype)``.

    Examples:
        A wall between two points blocks the segment; behind it, nothing:

        >>> import jax.numpy as jnp
        >>> from differt_tpu.rt import ray_intersect_any_triangle
        >>> wall = jnp.array(
        ...     [[[0.0, -9.0, -9.0], [0.0, 9.0, -9.0], [0.0, 0.0, 9.0]]]
        ... )
        >>> start = jnp.array([-1.0, 0.0, 0.0])
        >>> end = jnp.array([2.0, 0.0, 0.0])
        >>> bool(ray_intersect_any_triangle(start, end - start, wall))
        True
        >>> bool(ray_intersect_any_triangle(start, start - end, wall))
        False
    """
    ray_origins = jnp.asarray(ray_origins)
    ray_directions = jnp.asarray(ray_directions)
    triangle_vertices = jnp.asarray(triangle_vertices)
    dtype = jnp.result_type(ray_origins, ray_directions, triangle_vertices)

    if hit_tol is None:
        hit_tol = 100.0 * jnp.finfo(dtype).eps
    hit_threshold = 1.0 - jnp.asarray(hit_tol)

    smooth = smoothing_factor is not None
    num_triangles = triangle_vertices.shape[-3]
    if active_triangles is not None:
        active_triangles = jnp.asarray(active_triangles)

    batch = jnp.broadcast_shapes(
        ray_origins.shape[:-1],
        ray_directions.shape[:-1],
        triangle_vertices.shape[:-3],
        () if active_triangles is None else active_triangles.shape[:-1],
    )
    init = jnp.zeros(batch, dtype=dtype if smooth else bool)
    if num_triangles == 0:
        return init

    def tile_fn(tri: Array, active: Array | None) -> Array:
        t, hit = ray_intersect_triangle(
            ray_origins[..., None, :],
            ray_directions[..., None, :],
            tri,
            smoothing_factor=smoothing_factor,
            **kwargs,
        )
        if smooth:
            conf = jnp.minimum(
                hit, smoothing_function(hit_threshold - t, smoothing_factor)
            )
            return conf.sum(axis=-1, where=active)
        return ((t < hit_threshold) & hit).any(axis=-1, where=active)

    def combine(left: Array, right: Array) -> Array:
        return (left + right).clip(max=1.0) if smooth else left | right

    tile_size = _clamp_tile(num_triangles, batch_size)
    if tile_size == num_triangles:
        return combine(init, tile_fn(triangle_vertices, active_triangles))

    if num_triangles % tile_size and active_triangles is None:
        # Padded triangles must not count; materialize a mask for them.
        active_triangles = jnp.ones(num_triangles, dtype=bool)
    tri_tiles, _ = _into_tiles(triangle_vertices, -3, tile_size, 0.0)
    if active_triangles is None:
        return _scan_reduce(
            lambda tri: tile_fn(tri, None), combine, init, (tri_tiles,)
        )
    act_tiles, _ = _into_tiles(active_triangles, -1, tile_size, False)
    return _scan_reduce(tile_fn, combine, init, (tri_tiles, act_tiles))


def first_triangle_hit_by_ray(
    ray_origins: Float[ArrayLike, "*#batch 3"],
    ray_directions: Float[ArrayLike, "*#batch 3"],
    triangle_vertices: Float[ArrayLike, "*#batch num_triangles 3 3"],
    active_triangles: Bool[ArrayLike, "*#batch num_triangles"] | None = None,
    batch_size: int | None = 512,
    **kwargs: Any,
) -> tuple[Int[Array, " *batch"], Float[Array, " *batch"]]:
    """Index of and distance to the first triangle hit by each ray.

    Returns ``(-1, inf)`` when nothing is hit. Within a tile, ties keep the
    lowest triangle index (argmin); across tiles, an equal-t hit in a later
    tile wins.

    Examples:
        Two parallel walls: the nearer one wins; looking away misses:

        >>> import jax.numpy as jnp
        >>> from differt_tpu.rt import first_triangle_hit_by_ray
        >>> walls = jnp.array([
        ...     [[1.0, -9.0, -9.0], [1.0, 9.0, -9.0], [1.0, 0.0, 9.0]],
        ...     [[2.0, -9.0, -9.0], [2.0, 9.0, -9.0], [2.0, 0.0, 9.0]],
        ... ])
        >>> ray = jnp.array([1.0, 0.0, 0.0])
        >>> index, t = first_triangle_hit_by_ray(jnp.zeros(3), ray, walls)
        >>> int(index), float(t)
        (0, 1.0)
        >>> index, t = first_triangle_hit_by_ray(jnp.zeros(3), -ray, walls)
        >>> int(index)
        -1
    """
    ray_origins = jnp.asarray(ray_origins)
    ray_directions = jnp.asarray(ray_directions)
    triangle_vertices = jnp.asarray(triangle_vertices)
    t_dtype = jnp.result_type(ray_origins, ray_directions, triangle_vertices)

    num_triangles = triangle_vertices.shape[-3]
    if active_triangles is not None:
        active_triangles = jnp.asarray(active_triangles)

    batch = jnp.broadcast_shapes(
        ray_origins.shape[:-1],
        ray_directions.shape[:-1],
        triangle_vertices.shape[:-3],
        () if active_triangles is None else active_triangles.shape[:-1],
    )
    init = (
        jnp.full(batch, -1, dtype=jnp.int32),
        jnp.full(batch, jnp.inf, dtype=t_dtype),
    )
    if num_triangles == 0:
        return init

    def tile_fn(
        tri: Array, active: Array | None, offset: ArrayLike
    ) -> tuple[Array, Array]:
        t, hit = ray_intersect_triangle(
            ray_origins[..., None, :],
            ray_directions[..., None, :],
            tri,
            **kwargs,
        )
        if active is not None:
            hit = hit & active
        t = jnp.where(hit, t, jnp.inf)
        t_min = jnp.min(t, axis=-1)
        idx = jnp.argmin(t, axis=-1).astype(jnp.int32) + jnp.asarray(
            offset, dtype=jnp.int32
        )
        return jnp.where(jnp.isinf(t_min), -1, idx), t_min

    def combine(
        left: tuple[Array, Array], right: tuple[Array, Array]
    ) -> tuple[Array, Array]:
        # Strict `<` so an equal-t hit in a later tile wins, matching the
        # pre-tiling argmin semantics the Pallas kernels are pinned against.
        keep_left = left[1] < right[1]
        return (
            jnp.where(keep_left, left[0], right[0]),
            jnp.where(keep_left, left[1], right[1]),
        )

    tile_size = _clamp_tile(num_triangles, batch_size)
    if tile_size == num_triangles:
        return combine(init, tile_fn(triangle_vertices, active_triangles, 0))

    if num_triangles % tile_size and active_triangles is None:
        active_triangles = jnp.ones(num_triangles, dtype=bool)
    tri_tiles, num_tiles = _into_tiles(triangle_vertices, -3, tile_size, 0.0)
    offsets = jnp.arange(num_tiles, dtype=jnp.int32) * tile_size
    if active_triangles is None:
        return _scan_reduce(
            lambda tri, off: tile_fn(tri, None, off),
            combine,
            init,
            (tri_tiles, offsets),
        )
    act_tiles, _ = _into_tiles(active_triangles, -1, tile_size, False)
    return _scan_reduce(tile_fn, combine, init, (tri_tiles, act_tiles, offsets))


def triangles_visible_from_vertex(
    vertex: Float[ArrayLike, "*#batch 3"],
    triangle_vertices: Float[ArrayLike, "*#batch num_triangles 3 3"],
    active_triangles: Bool[ArrayLike, "*#batch num_triangles"] | None = None,
    num_rays: int = int(1e6),
    batch_size: int | None = 512,
    **kwargs: Any,
) -> Bool[Array, "*batch num_triangles"]:
    """Estimate per-triangle visibility from a vertex by ray launching.

    Launches a frustum-restricted Fibonacci lattice of ``num_rays`` rays and
    scatter-marks each first-hit triangle as visible. The ray axis is tiled
    the same way as the triangle scans above (padded rays have zero
    direction, hit nothing, and their ``-1`` indices are dropped by the
    scatter).
    """
    vertex = jnp.asarray(vertex)
    triangle_vertices = jnp.asarray(triangle_vertices)

    centers = triangle_vertices.mean(axis=-2, keepdims=True)
    world_vertices = jnp.concatenate((triangle_vertices, centers), axis=-2).reshape(
        *triangle_vertices.shape[:-3], -1, 3
    )

    if active_triangles is not None:
        active_triangles = jnp.asarray(active_triangles)
        active_vertices = jnp.repeat(active_triangles, 4, axis=-1)
    else:
        active_vertices = None

    frustum = viewing_frustum(vertex, world_vertices, active_vertices=active_vertices)

    ray_directions = jnp.vectorize(
        lambda f: fibonacci_lattice(num_rays, frustum=f),
        signature="(2,3)->(n,3)",
    )(frustum)

    batch = jnp.broadcast_shapes(
        vertex.shape[:-1],
        ray_directions.shape[:-2],
        triangle_vertices.shape[:-3],
        () if active_triangles is None else active_triangles.shape[:-1],
    )
    num_triangles = triangle_vertices.shape[-3]

    def tile_fn(ray_dirs: Array) -> Array:
        idx, _ = first_triangle_hit_by_ray(
            vertex[..., None, :],
            ray_dirs,
            triangle_vertices[..., None, :, :, :],
            active_triangles=None
            if active_triangles is None
            else active_triangles[..., None, :],
            batch_size=None,
            **kwargs,
        )
        return idx

    def mark(visible: Array, hit_indices: Array) -> Array:
        grid = jnp.indices(visible.shape, sparse=True)
        return visible.at[(*grid[:-1], hit_indices)].set(
            True, mode="drop", wrap_negative_indices=False
        )

    init = jnp.zeros((*batch, num_triangles), dtype=bool)
    tile_size = _clamp_tile(num_rays, batch_size)
    if tile_size == num_rays:
        return mark(init, tile_fn(ray_directions))

    ray_tiles, _ = _into_tiles(ray_directions, -2, tile_size, 0.0)
    return _scan_reduce(tile_fn, mark, init, (ray_tiles,))
