"""Vector and coordinate utilities (pure JAX).

Reference parity: ``differt.geometry`` free functions in
differt/src/differt/geometry/_utils.py:29-348 and :930-993.
All functions broadcast over arbitrary leading batch dimensions and are safe
to ``vmap`` / ``jit`` / shard.
"""

from functools import partial

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Float, Int


@partial(jax.jit, static_argnames=("keepdims",))
def normalize(
    vectors: Float[ArrayLike, "*batch 3"],
    keepdims: bool = False,
) -> tuple[Float[Array, "*batch 3"], Float[Array, " *batch"]]:
    """Normalize vectors, returning ``(unit_vectors, lengths)``.

    Zero-length vectors are returned unchanged with a length of 0 (division by
    one instead of zero), so gradients stay finite at the origin.
    Reference parity: _utils.py:29-72.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import normalize
        >>> unit, length = normalize(jnp.array([3.0, 0.0, 4.0]))
        >>> unit.tolist(), float(length)
        ([0.6000000238418579, 0.0, 0.800000011920929], 5.0)
        >>> normalize(jnp.zeros(3))[1].tolist()  # zero-safe
        0.0
    """
    vectors = jnp.asarray(vectors)
    lengths = jnp.linalg.norm(vectors, axis=-1, keepdims=True)
    safe = jnp.where(lengths == 0.0, jnp.ones_like(lengths), lengths)
    unit = vectors / safe
    return unit, (lengths if keepdims else jnp.squeeze(lengths, axis=-1))


@jax.jit
def perpendicular_vector(u: Float[ArrayLike, "*batch 3"]) -> Float[Array, "*batch 3"]:
    """Return a unit vector perpendicular to ``u``.

    Deterministic branch-free construction: pick the candidate axis swap with
    the larger leading component, then orthogonalize via a cross product.
    Reference parity: _utils.py:75-108 (same branch rule so outputs match).
    """
    u = jnp.asarray(u)
    zeros = jnp.zeros_like(u[..., 0])
    cand_a = jnp.stack((-u[..., 1], u[..., 0], zeros), axis=-1)
    cand_b = jnp.stack((zeros, -u[..., 2], u[..., 1]), axis=-1)
    v = jnp.where(
        (jnp.abs(u[..., 0]) > jnp.abs(u[..., 1]))[..., None], cand_a, cand_b
    )
    return normalize(jnp.cross(u, v))[0]


@jax.jit
def orthogonal_basis(
    u: Float[ArrayLike, "*batch 3"],
) -> tuple[Float[Array, "*batch 3"], Float[Array, "*batch 3"]]:
    """Return unit vectors ``(v, w)`` forming an orthogonal basis with ``u``.

    Reference parity: _utils.py:111-146.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import orthogonal_basis
        >>> v, w = orthogonal_basis(jnp.array([0.0, 0.0, 1.0]))
        >>> float(jnp.dot(v, w)), float(jnp.linalg.norm(v))
        (0.0, 1.0)
    """
    u = jnp.asarray(u)
    w = perpendicular_vector(u)
    v = normalize(jnp.cross(w, u))[0]
    return v, w


@jax.jit
def path_length(
    path: Float[ArrayLike, "*batch path_length 3"],
) -> Float[Array, " *batch"]:
    """Total Euclidean length of each polyline path.

    Reference parity: _utils.py:149-181.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import path_length
        >>> path = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [3.0, 4.0, 0.0]])
        >>> float(path_length(path))
        7.0
    """
    path = jnp.asarray(path)
    segments = jnp.diff(path, axis=-2)
    return jnp.sum(jnp.linalg.norm(segments, axis=-1), axis=-1)


@jax.jit
def rotation_matrix_along_x_axis(
    angle: Float[ArrayLike, ""],
) -> Float[Array, "3 3"]:
    """Rotation matrix about the x axis. Reference parity: _utils.py:184-216."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    return jnp.stack((
        jnp.stack((one, zero, zero)),
        jnp.stack((zero, c, -s)),
        jnp.stack((zero, s, c)),
    ))


@jax.jit
def rotation_matrix_along_y_axis(
    angle: Float[ArrayLike, ""],
) -> Float[Array, "3 3"]:
    """Rotation matrix about the y axis. Reference parity: _utils.py:219-251."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    return jnp.stack((
        jnp.stack((c, zero, s)),
        jnp.stack((zero, one, zero)),
        jnp.stack((-s, zero, c)),
    ))


@jax.jit
def rotation_matrix_along_z_axis(
    angle: Float[ArrayLike, ""],
) -> Float[Array, "3 3"]:
    """Rotation matrix about the z axis. Reference parity: _utils.py:254-286."""
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    return jnp.stack((
        jnp.stack((c, -s, zero)),
        jnp.stack((s, c, zero)),
        jnp.stack((zero, zero, one)),
    ))


@jax.jit
def rotation_matrix_along_axis(
    angle: Float[ArrayLike, ""],
    axis: Float[ArrayLike, "3"],
) -> Float[Array, "3 3"]:
    """Rodrigues rotation matrix about an arbitrary (unit) axis.

    Reference parity: _utils.py:289-348.
    """
    axis = jnp.asarray(axis)
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    eye = jnp.identity(3, dtype=axis.dtype)
    zero = jnp.zeros_like(axis[0])
    cross = jnp.stack((
        jnp.stack((zero, -axis[2], axis[1])),
        jnp.stack((axis[2], zero, -axis[0])),
        jnp.stack((-axis[1], axis[0], zero)),
    ))
    outer = jnp.outer(axis, axis)
    return c * eye + s * cross + (1.0 - c) * outer


@jax.jit
def cartesian_to_spherical(
    xyz: Float[ArrayLike, "*batch 3"],
) -> Float[Array, "*batch 3"]:
    """Cartesian -> spherical ``(r, polar, azimuth)``.

    Polar angle in [0, pi] from +z, azimuth in [-pi, pi) via atan2.
    Reference parity: _utils.py:930-955.
    """
    xyz = jnp.asarray(xyz)
    r = jnp.linalg.norm(xyz, axis=-1)
    r_safe = jnp.where(r == 0.0, jnp.ones_like(r), r)
    polar = jnp.arccos(xyz[..., 2] / r_safe)
    azimuth = jnp.arctan2(xyz[..., 1], xyz[..., 0])
    return jnp.stack((r, polar, azimuth), axis=-1)


@jax.jit
def spherical_to_cartesian(
    rpa: Float[ArrayLike, "*batch 3"] | Float[ArrayLike, "*batch 2"],
) -> Float[Array, "*batch 3"]:
    """Spherical ``(r, polar, azimuth)`` (or ``(polar, azimuth)``; r=1) -> Cartesian.

    Reference parity: _utils.py:958-993.
    """
    rpa = jnp.asarray(rpa)
    p = rpa[..., -2]
    a = rpa[..., -1]
    sp = jnp.sin(p)
    xyz = jnp.stack((sp * jnp.cos(a), sp * jnp.sin(a), jnp.cos(p)), axis=-1)
    if rpa.shape[-1] == 3:
        xyz = xyz * rpa[..., 0, None]
    return xyz


def assemble_path(
    from_vertex: Float[ArrayLike, "*#batch 3"],
    intermediate_vertices: Float[ArrayLike, "*#batch num_inter 3"]
    | Float[ArrayLike, "*#batch 3"],
    to_vertex: Float[ArrayLike, "*#batch 3"] | None = None,
) -> Float[Array, "*batch path_length 3"]:
    """Concatenate start, intermediate, and end vertices into full paths.

    When ``to_vertex`` is ``None``, ``intermediate_vertices`` is interpreted
    as the end vertex (2-vertex paths). Reference parity: _utils.py:493-569.
    """
    from_vertex = jnp.asarray(from_vertex)
    intermediate_vertices = jnp.asarray(intermediate_vertices)
    if to_vertex is None:
        to_vertex = intermediate_vertices
        batch = jnp.broadcast_shapes(from_vertex.shape[:-1], to_vertex.shape[:-1])
        return jnp.concatenate(
            (
                jnp.broadcast_to(from_vertex[..., None, :], (*batch, 1, 3)),
                jnp.broadcast_to(to_vertex[..., None, :], (*batch, 1, 3)),
            ),
            axis=-2,
        )
    to_vertex = jnp.asarray(to_vertex)
    batch = jnp.broadcast_shapes(
        from_vertex.shape[:-1],
        intermediate_vertices.shape[:-2],
        to_vertex.shape[:-1],
    )
    return jnp.concatenate(
        (
            jnp.broadcast_to(from_vertex[..., None, :], (*batch, 1, 3)),
            jnp.broadcast_to(
                intermediate_vertices,
                (*batch, *intermediate_vertices.shape[-2:]),
            ),
            jnp.broadcast_to(to_vertex[..., None, :], (*batch, 1, 3)),
        ),
        axis=-2,
    )


@jax.jit
def min_distance_between_cells(
    cell_vertices: Float[ArrayLike, "*batch 3"],
    cell_ids: Int[ArrayLike, " *batch"],
) -> Float[Array, " *batch"]:
    """For every vertex, min distance to any vertex in a *different* cell.

    Implemented as a scan over vertices (O(n^2) work, O(n) memory).
    Reference parity: _utils.py:572-616.
    """
    cell_vertices = jnp.asarray(cell_vertices)
    cell_ids = jnp.asarray(cell_ids)
    flat_vertices = cell_vertices.reshape(-1, 3)
    flat_ids = cell_ids.reshape(-1)

    def body(_, vertex_and_id):
        vertex, cid = vertex_and_id
        dists = jnp.linalg.norm(flat_vertices - vertex, axis=-1)
        return None, jnp.min(dists, initial=jnp.inf, where=flat_ids != cid)

    _, out = jax.lax.scan(body, None, (flat_vertices, flat_ids))
    return out.reshape(cell_ids.shape)
