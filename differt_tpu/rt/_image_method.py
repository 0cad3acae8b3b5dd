"""Image-method specular path solver (pure JAX, scan-based).

Reference parity: differt/src/differt/geometry/_solver_image_method.py.
The forward pass computes consecutive mirror images of the source, the
backward pass intersects segments toward those images with each mirror plane
(both as ``lax.scan``), yielding the unique specular-reflection path for a
given ordered list of (infinite) mirrors. Fully differentiable; impossible
configurations surface as inf/NaN vertices, which the solver layer masks.
"""

import chex
import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, Float

from ..utils import smoothing_function


@jax.jit
def image_of_vertex_with_respect_to_mirror(
    vertex: Float[ArrayLike, "*#batch 3"],
    mirror_vertex: Float[ArrayLike, "*#batch 3"],
    mirror_normal: Float[ArrayLike, "*#batch 3"],
) -> Float[Array, "*batch 3"]:
    """Mirror image of ``vertex`` across the plane (vertex, unit normal).

    Reference parity: _solver_image_method.py:11-79.
    """
    vertex = jnp.asarray(vertex)
    mirror_vertex = jnp.asarray(mirror_vertex)
    mirror_normal = jnp.asarray(mirror_normal)
    offset = jnp.sum((vertex - mirror_vertex) * mirror_normal, axis=-1, keepdims=True)
    return vertex - 2.0 * offset * mirror_normal


@jax.jit
def intersection_of_ray_with_plane(
    ray_origin: Float[ArrayLike, "*#batch 3"],
    ray_direction: Float[ArrayLike, "*#batch 3"],
    plane_vertex: Float[ArrayLike, "*#batch 3"],
    plane_normal: Float[ArrayLike, "*#batch 3"],
) -> Float[Array, "*batch 3"]:
    """Intersection of a ray with an infinite plane.

    Parallel rays off the plane yield inf (propagated as "invalid path");
    parallel rays *on* the plane return the origin itself.
    Reference parity: _solver_image_method.py:82-135.
    """
    ray_origin = jnp.asarray(ray_origin)
    ray_direction = jnp.asarray(ray_direction)
    plane_vertex = jnp.asarray(plane_vertex)
    plane_normal = jnp.asarray(plane_normal)

    dn = jnp.sum(ray_direction * plane_normal, axis=-1, keepdims=True)
    vn = jnp.sum((plane_vertex - ray_origin) * plane_normal, axis=-1, keepdims=True)
    parallel = dn == 0.0
    t = vn / jnp.where(parallel, jnp.ones_like(dn), dn)

    point = ray_origin + ray_direction * t
    return jnp.where(parallel & (vn != 0.0), jnp.full_like(point, jnp.inf), point)


def _image_method_single(
    from_vertex: Float[Array, "3"],
    to_vertex: Float[Array, "3"],
    mirror_vertices: Float[Array, "num_mirrors 3"],
    mirror_normals: Float[Array, "num_mirrors 3"],
) -> Float[Array, "num_mirrors 3"]:
    def forward(image: Array, mirror: tuple[Array, Array]) -> tuple[Array, Array]:
        m_vertex, m_normal = mirror
        image = image_of_vertex_with_respect_to_mirror(image, m_vertex, m_normal)
        return image, image

    _, images = jax.lax.scan(forward, from_vertex, (mirror_vertices, mirror_normals))

    def backward(point: Array, inputs: tuple[Array, Array, Array]) -> tuple[Array, Array]:
        m_vertex, m_normal, image = inputs
        # Replace inf with 0 before subtracting to avoid inf - inf = NaN; the
        # inf-ness is restored afterwards so invalidity still propagates.
        invalid = jnp.isinf(point)
        safe_point = jnp.where(invalid, jnp.zeros_like(point), point)
        hit = intersection_of_ray_with_plane(
            safe_point, image - safe_point, m_vertex, m_normal
        )
        hit = jnp.where(invalid, jnp.full_like(hit, jnp.inf), hit)
        return hit, hit

    _, points = jax.lax.scan(
        backward,
        to_vertex,
        (mirror_vertices, mirror_normals, images),
        reverse=True,
    )
    return points


@jax.jit
def image_method(
    from_vertex: Float[ArrayLike, "*#batch 3"],
    to_vertex: Float[ArrayLike, "*#batch 3"],
    mirror_vertices: Float[ArrayLike, "*#batch num_mirrors 3"],
    mirror_normals: Float[ArrayLike, "*#batch num_mirrors 3"],
) -> Float[Array, "*batch num_mirrors 3"]:
    """Specular path through an ordered list of mirrors (image method).

    Returns only the intermediate reflection points (use
    :func:`assemble_path` to add the endpoints). Invalid configurations
    produce non-finite vertices. Reference parity:
    _solver_image_method.py:206-363.

    Examples:
        A single mirror in the plane ``x = 1`` (normal along z): the unique
        specular bounce between ``(0, 0, 1)`` and ``(2, 0, 1)`` is at the
        midpoint on the mirror plane.

        >>> import jax.numpy as jnp
        >>> from differt_tpu.rt import image_method
        >>> image_method(
        ...     jnp.array([0.0, 0.0, 1.0]),
        ...     jnp.array([2.0, 0.0, 1.0]),
        ...     jnp.array([[1.0, 0.0, 0.0]]),
        ...     jnp.array([[0.0, 0.0, 1.0]]),
        ... ).tolist()
        [[1.0, 0.0, 0.0]]
    """
    from_vertex = jnp.asarray(from_vertex)
    to_vertex = jnp.asarray(to_vertex)
    mirror_vertices = jnp.asarray(mirror_vertices)
    mirror_normals = jnp.asarray(mirror_normals)

    if mirror_vertices.shape[-2] == 0:
        batch = jnp.broadcast_shapes(
            from_vertex.shape[:-1],
            to_vertex.shape[:-1],
            mirror_vertices.shape[:-2],
            mirror_normals.shape[:-2],
        )
        dtype = jnp.result_type(from_vertex, to_vertex, mirror_vertices, mirror_normals)
        return jnp.empty((*batch, 0, 3), dtype=dtype)

    return jnp.vectorize(
        _image_method_single,
        signature="(3),(3),(n,3),(n,3)->(n,3)",
    )(from_vertex, to_vertex, mirror_vertices, mirror_normals)


@jax.jit
def consecutive_vertices_are_on_same_side_of_mirror(
    vertices: Float[ArrayLike, "*#batch num_vertices 3"],
    mirror_vertices: Float[ArrayLike, "*#batch num_mirrors 3"],
    mirror_normals: Float[ArrayLike, "*#batch num_mirrors 3"],
    *,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
) -> Bool[Array, "*#batch num_mirrors"] | Float[Array, "*#batch num_mirrors"]:
    """Check that the vertices surrounding each mirror lie on the same side.

    ``num_vertices`` must equal ``num_mirrors + 2``. Needed after
    :func:`image_method`, which can produce paths passing *through* mirrors.
    Reference parity: _solver_image_method.py:366-455.
    """
    vertices = jnp.asarray(vertices)
    mirror_vertices = jnp.asarray(mirror_vertices)
    mirror_normals = jnp.asarray(mirror_normals)

    chex.assert_axis_dimension(
        vertices, -2, mirror_vertices.shape[-2] + 2, exception_type=TypeError
    )

    if mirror_vertices.shape[-2] == 0:
        batch = jnp.broadcast_shapes(
            vertices.shape[:-2],
            mirror_vertices.shape[:-2],
            mirror_normals.shape[:-2],
        )
        dtype = (
            bool
            if smoothing_factor is None
            else jnp.result_type(vertices, mirror_vertices, mirror_normals)
        )
        return jnp.empty((*batch, 0), dtype=dtype)

    d_prev = vertices[..., :-2, :] - mirror_vertices
    d_next = vertices[..., 2:, :] - mirror_vertices
    dot_prev = jnp.sum(d_prev * mirror_normals, axis=-1)
    dot_next = jnp.sum(d_next * mirror_normals, axis=-1)

    if smoothing_factor is not None:
        return smoothing_function(
            jnp.sign(dot_prev) * jnp.sign(dot_next), smoothing_factor
        )
    return jnp.sign(dot_prev) == jnp.sign(dot_next)
