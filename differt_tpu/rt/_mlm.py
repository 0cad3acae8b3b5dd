"""Multipath Lifetime Map (MLM) via shooting-and-bouncing rays.

Reference parity: ``Scene.compute_tx_mlm``
(differt/src/differt/geometry/_scene.py:62-302, 1250-1371), which uses a Warp
CUDA kernel with per-cell ``atomic_or`` of a path hash. Here the same
computation is expressed as pure XLA: a ``lax.scan`` over bounces, a
vectorized receiver-plane crossing test, and a bit-planed scatter-max that
emulates the atomic OR (OR of a set == per-bit any == per-bit max), which
XLA lowers to a single deterministic scatter.

Each grid cell accumulates the OR of 32-bit hashes of the primitive-index
sequences of all ray paths crossing it: cells with equal values share the
same multipath structure (the MLM fingerprint of mlm-eucap2025). The hash
functions use the same well-known public constants as the reference (the
boost ``hash_combine`` golden ratio 0x9E3779B9, the degski integer hash
multiplier 0x045D9F3B, and the FNV-1a offset basis 0x811C9DC5 as the seed)
so per-cell hash VALUES are comparable bit-for-bit against the reference
kernel's output given the same hit sequences — which is exactly what the
reference-oracle test asserts.
"""

from functools import partial

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Float, Int

from ..geometry._lattice import fibonacci_lattice, viewing_frustum

# Self-intersection guard used by the reference MLM kernel (_scene.py:105):
# after the first bounce, each closest-hit query starts this far along the
# ray, and the hit distance is extended by the same amount for the
# receiver-plane crossing test.
_MLM_EPSILON = 1e-4


def _hash_int(x: Array) -> Array:
    """32-bit integer avalanche hash (degski multiplier, as the reference).

    Pinned to the exact constants the reference Warp kernel uses, so the
    MLM hash maps agree bit-for-bit (oracled in
    ``tests/test_launch_vs_reference.py``):

    >>> import jax.numpy as jnp
    >>> int(_hash_int(jnp.uint32(0)))
    0
    >>> int(_combine_hashes(jnp.uint32(1), jnp.uint32(2)))
    2654435834
    """
    x = x.astype(jnp.uint32)
    m = jnp.uint32(0x045D9F3B)
    x = ((x >> 16) ^ x) * m
    x = ((x >> 16) ^ x) * m
    return (x >> 16) ^ x


def _combine_hashes(h1: Array, h2: Array) -> Array:
    """Boost-style ``hash_combine``."""
    return h1 ^ (h2 + jnp.uint32(0x9E3779B9) + (h1 << 6) + (h1 >> 2))


@partial(
    jax.jit, static_argnames=("order", "min_order", "grid_size", "assume_quads")
)
def _compute_tx_mlm(
    mesh,
    tx_vertices: Float[Array, "num_tx 3"],
    ray_directions: Float[Array, "num_tx num_rays 3"],
    receiver_plane_z: Float[Array, ""],
    grid_min: Float[Array, "2"],
    grid_max: Float[Array, "2"],
    *,
    order: int,
    min_order: int,
    grid_size: tuple[int, int],
    assume_quads: bool,
) -> Int[Array, "num_tx grid_m grid_n"]:
    num_tx, num_rays = ray_directions.shape[:2]
    m, n = grid_size
    extent = grid_max - grid_min
    cell = extent / jnp.array([m, n], dtype=extent.dtype)
    eps = jnp.asarray(_MLM_EPSILON, dtype=ray_directions.dtype)

    def bounce(carry, bounce_idx):
        origins, directions, valid, path_hash = carry
        # After the first segment, start the query slightly along the ray so
        # the reflection point's own triangle is not re-hit.
        offset = jnp.where(bounce_idx > 0, eps, 0.0)
        query_origins = origins + offset * directions[..., :]
        triangles, t_hit = mesh.first_triangle_hit_by_ray(
            query_origins, directions
        )
        hit = jnp.isfinite(t_hit)
        # The crossing window extends to the (offset-extended) hit distance.
        t_window = jnp.where(hit, t_hit + offset, jnp.inf)

        # Receiver-plane crossing within this bounce segment.
        dz = directions[..., 2]
        dz_safe = jnp.where(dz == 0.0, jnp.ones_like(dz), dz)
        t_plane = (receiver_plane_z - query_origins[..., 2]) / dz_safe
        crosses = (
            (jnp.abs(dz) > 1e-6)
            & (t_plane > 0.0)
            & (t_plane < t_window)
            & valid
            & (bounce_idx >= min_order)
        )

        hit_xy = query_origins[..., :2] + t_plane[..., None] * directions[..., :2]
        # Bounds are tested on the crossing point itself, then the cell
        # indices are clamped (a point exactly on the max edge lands in the
        # last cell), matching the reference kernel (_scene.py:126-143).
        in_grid = (
            crosses
            & (hit_xy[..., 0] >= grid_min[0])
            & (hit_xy[..., 0] <= grid_max[0])
            & (hit_xy[..., 1] >= grid_min[1])
            & (hit_xy[..., 1] <= grid_max[1])
        )
        cell_i = jnp.floor((hit_xy[..., 0] - grid_min[0]) / cell[0])
        cell_j = jnp.floor((hit_xy[..., 1] - grid_min[1]) / cell[1])
        cell_i = jnp.clip(cell_i.astype(jnp.int32), 0, m - 1)
        cell_j = jnp.clip(cell_j.astype(jnp.int32), 0, n - 1)

        # Record the hash of the bounces made SO FAR (the segment belongs to
        # the path prefix, not to the triangle it is about to hit).
        emitted = jnp.where(in_grid, path_hash, jnp.zeros_like(path_hash))

        # Advance rays and fold the new hit into the running hash.
        valid = valid & hit
        t_step = jnp.where(hit, t_hit, jnp.zeros_like(t_hit))
        origins = query_origins + t_step[..., None] * directions
        normals = jnp.take(mesh.normals, triangles, axis=0)
        directions = (
            directions
            - 2.0 * jnp.sum(directions * normals, axis=-1, keepdims=True) * normals
        )
        hash_face = triangles // 2 if assume_quads else triangles
        new_hash = _combine_hashes(path_hash, _hash_int(hash_face))
        path_hash = jnp.where(hit, new_hash, path_hash)

        return (origins, directions, valid, path_hash), (
            in_grid,
            cell_i,
            cell_j,
            emitted,
        )

    origins = jnp.broadcast_to(tx_vertices[:, None, :], ray_directions.shape)
    valid = jnp.ones((num_tx, num_rays), dtype=bool)
    # FNV-1a offset basis: the seed of every path hash (as the reference).
    path_hash = jnp.full((num_tx, num_rays), 0x811C9DC5, dtype=jnp.uint32)

    _, (in_grid, cell_i, cell_j, hashes) = jax.lax.scan(
        bounce,
        (origins, ray_directions, valid, path_hash),
        jnp.arange(order + 1),
    )

    # Emulated atomic OR: expand the hash into 32 bit-planes, scatter-max
    # each bit, then recombine. A single scatter per TX, deterministic.
    bits = jnp.arange(32, dtype=jnp.uint32)
    # [bounces num_tx num_rays 32]
    bit_values = ((hashes[..., None] >> bits) & jnp.uint32(1)).astype(jnp.uint32)
    bit_values = jnp.where(in_grid[..., None], bit_values, jnp.uint32(0))

    flat_cell = jnp.where(in_grid, cell_i * n + cell_j, 0)

    def scatter_tx(cells, values):
        # cells: [bounces num_rays], values: [bounces num_rays 32]
        acc = jnp.zeros((m * n, 32), dtype=jnp.uint32)
        acc = acc.at[cells.reshape(-1), :].max(values.reshape(-1, 32))
        return acc

    # vmap over TX axis (axis 1 of the scan outputs).
    acc = jax.vmap(scatter_tx, in_axes=(1, 1))(flat_cell, bit_values)
    combined = jnp.sum(acc << bits, axis=-1, dtype=jnp.uint32)
    return combined.reshape(num_tx, m, n).astype(jnp.int32)


def compute_tx_mlm(
    scene,
    *,
    num_rays: int = int(1e4),
    order: int = 2,
    min_order: int = 0,
    receiver_plane_z: Float[ArrayLike, ""] = 0.0,
    grid_bounds: Float[ArrayLike, "2 2"] | None = None,
    grid_size: tuple[int, int] = (100, 100),
) -> Int[Array, "num_tx grid_m grid_n"]:
    """Compute a per-transmitter multipath lifetime map.

    Rays are launched on a frustum-restricted Fibonacci lattice from each
    transmitter, bounced ``order + 1`` times, and every crossing of the
    horizontal receiver plane by a bounce of index ``>= min_order`` records
    a hash of the path's primitive sequence into the crossed grid cell
    (OR-accumulated).

    Args:
        scene: The scene (transmitters + mesh are used).
        num_rays: Number of rays per transmitter.
        order: Maximum number of bounces.
        min_order: Minimum bounce index for a crossing to be recorded.
        receiver_plane_z: Height of the receiver plane.
        grid_bounds: ``[[min_x, min_y], [max_x, max_y]]`` of the map;
            defaults to the mesh footprint.
        grid_size: Number of cells along x and y.

    Returns:
        The per-cell multipath hash map, one per transmitter.
    """
    tx_vertices = scene.transmitters.reshape(-1, 3)
    mesh = scene.mesh

    if grid_bounds is None:
        bbox = mesh.bounding_box
        grid_min = bbox[0, :2]
        grid_max = bbox[1, :2]
    else:
        grid_bounds = jnp.asarray(grid_bounds)
        grid_min = grid_bounds[0]
        grid_max = grid_bounds[1]

    # Frustum over the mesh AND the receiver-plane corners (rays must also
    # cover the map region), with the polar band opened to the full lower
    # hemisphere: grid cells between the corners subtend steeper downward
    # angles than the corners themselves (reference _scene.py:255-273).
    z = jnp.asarray(receiver_plane_z, dtype=tx_vertices.dtype)
    corners = jnp.stack([
        jnp.stack((grid_min[0], grid_min[1], z)),
        jnp.stack((grid_max[0], grid_min[1], z)),
        jnp.stack((grid_max[0], grid_max[1], z)),
        jnp.stack((grid_min[0], grid_max[1], z)),
    ])
    world_vertices = jnp.concatenate(
        (mesh.triangle_vertices.reshape(-1, 3), corners), axis=0
    )
    active_vertices = None
    if mesh.mask is not None:
        active_vertices = jnp.concatenate(
            (jnp.repeat(mesh.mask, 3), jnp.ones(4, dtype=bool))
        )

    def gen_rays(t):
        f = viewing_frustum(t, world_vertices, active_vertices=active_vertices)
        f = f.at[1, 1].set(jnp.pi)
        return fibonacci_lattice(num_rays, frustum=f)

    ray_directions = jax.vmap(gen_rays)(tx_vertices)

    return _compute_tx_mlm(
        mesh,
        tx_vertices,
        ray_directions,
        jnp.asarray(receiver_plane_z),
        grid_min,
        grid_max,
        order=order,
        min_order=min_order,
        grid_size=grid_size,
        assume_quads=mesh.assume_quads,
    )
