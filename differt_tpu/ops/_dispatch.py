"""Backend dispatch + differentiable wrappers for accelerated ray casting.

Backends:

- ``"pallas"``: the culled Pallas kernels of :mod:`differt_tpu.ops._pallas_rt`,
  compiled for an NVIDIA GPU through Triton.
- ``"jax"``: the portable plain-JAX scans of :mod:`differt_tpu.rt`.
- ``"auto"`` (default): ``"pallas"`` on a GPU, ``"jax"`` elsewhere.

The kernels run in the Pallas interpreter only when asked for it
(``set_backend("pallas", interpret=True)``, as the tests do); asking for
them compiled on a device they cannot compile for raises.

The mesh-level methods keep the exact numerical contract of the reference's
Warp-backed methods (_mesh.py:3018-3253): any-hit offsets the ray origin by
``hit_tol`` along the segment and shrinks the valid range to
``1 - 2 * hit_tol`` to avoid self-intersections; closest-hit exposes a
differentiable distance via a custom VJP that recomputes ``t`` from the
frozen hit index (_mesh.py:226-344).
"""

from functools import partial
from typing import TYPE_CHECKING, Any

import jax
import jax.numpy as jnp

from .._typing import Array, Bool, Float, Int
from ..rt._scan import (
    first_triangle_hit_by_ray as _jax_first_hit,
    ray_intersect_any_triangle as _jax_anyhit,
)

if TYPE_CHECKING:
    from ..geometry._mesh import Mesh

_BACKEND: str = "auto"
_INTERPRET: bool = False


def set_backend(backend: str, *, interpret: bool = False) -> None:
    """Set the global ray-casting backend: 'auto', 'pallas', or 'jax'.

    ``interpret=True`` runs the Pallas kernels in the interpreter (on any
    device, slowly); it is the only way to run them off a GPU.

    The backend is chosen while a function is traced, so a change drops
    every compiled program (``jax.clear_caches``) rather than let a cached
    one keep the old choice.

    Examples:
        >>> from differt_tpu.ops import get_backend, set_backend
        >>> set_backend("jax")
        >>> get_backend()
        'jax'
        >>> set_backend("auto")  # 'pallas' on a GPU, 'jax' elsewhere
    """
    if backend not in ("auto", "pallas", "jax"):
        msg = f"Unknown backend {backend!r}, expected 'auto', 'pallas', or 'jax'."
        raise ValueError(msg)
    global _BACKEND, _INTERPRET
    if (backend, interpret) != (_BACKEND, _INTERPRET):
        jax.clear_caches()
    _BACKEND = backend
    _INTERPRET = interpret


def get_backend() -> str:
    """Resolve the active backend name ('pallas' or 'jax')."""
    if _BACKEND != "auto":
        return _BACKEND
    return "pallas" if jax.default_backend() == "gpu" else "jax"


def _anyhit_backend(
    ray_origins: Float[Array, "*batch 3"],
    ray_directions: Float[Array, "*batch 3"],
    triangle_vertices: Float[Array, "num_triangles 3 3"],
    active_triangles: Bool[Array, " num_triangles"] | None,
    hit_threshold: Float[Array, ""],
    epsilon: Float[Array, ""] | None,
    active_rays: Bool[Array, " *batch"] | None = None,
) -> Bool[Array, " *batch"]:
    if get_backend() == "pallas":
        from ._pallas_rt import pallas_ray_intersect_any_triangle

        if active_rays is not None:
            # Inactive rays get a negative threshold: their slab interval
            # is empty inside the kernel, so they are never "pending" and
            # the AABB culling skips their (potentially wild) segments.
            hit_threshold = jnp.where(active_rays, hit_threshold, -1.0)
        return pallas_ray_intersect_any_triangle(
            ray_origins,
            ray_directions,
            triangle_vertices,
            active_triangles,
            hit_threshold=hit_threshold,
            epsilon=epsilon,
            interpret=_INTERPRET,
        )
    out = _jax_anyhit(
        ray_origins,
        ray_directions,
        triangle_vertices,
        active_triangles,
        hit_tol=1.0 - hit_threshold,
        epsilon=epsilon,
    )
    if active_rays is not None:
        out = out & active_rays
    return out


def _closest_hit_backend(
    ray_origins: Float[Array, "num_rays 3"],
    ray_directions: Float[Array, "num_rays 3"],
    triangle_vertices: Float[Array, "num_triangles 3 3"],
    active_triangles: Bool[Array, " num_triangles"] | None,
) -> tuple[Int[Array, " num_rays"], Float[Array, " num_rays"]]:
    if get_backend() == "pallas":
        from ._pallas_rt import pallas_first_triangle_hit_by_ray

        return pallas_first_triangle_hit_by_ray(
            ray_origins,
            ray_directions,
            triangle_vertices,
            active_triangles,
            interpret=_INTERPRET,
        )
    return _jax_first_hit(
        ray_origins, ray_directions, triangle_vertices, active_triangles
    )


def dispatch_ray_intersect_any_triangle(
    mesh: "Mesh",
    ray_origins: Float[Array, "*batch 3"],
    ray_directions: Float[Array, "*batch 3"],
    *,
    hit_tol: Float[Array, ""] | None = None,
    active_rays: Bool[Array, " *batch"] | None = None,
    **kwargs: Any,
) -> Bool[Array, " *batch"]:
    """Mesh-level any-hit occlusion test (non-differentiable, fast path).

    ``active_rays`` marks the rays whose result matters; inactive rays
    report "not blocked" and are skipped by the accelerated backend (their
    coordinates are sanitized first, so non-finite segments from invalid
    image-method paths are harmless).
    """
    if mesh.num_triangles == 0:
        batch = jnp.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
        return jnp.zeros(batch, dtype=bool)

    ray_origins, ray_directions = jnp.broadcast_arrays(ray_origins, ray_directions)

    if active_rays is not None:
        active_rays = jnp.broadcast_to(active_rays, ray_origins.shape[:-1])
        keep = active_rays[..., None]
        ray_origins = jnp.where(keep, ray_origins, 0.0)
        ray_directions = jnp.where(keep, ray_directions, 0.0)

    if hit_tol is None:
        dtype = jnp.result_type(ray_origins, ray_directions, mesh.vertices)
        hit_tol = 100.0 * jnp.finfo(dtype).eps
    hit_tol = jnp.asarray(hit_tol)

    # Offset origins slightly along the segment so rays starting exactly on a
    # face do not self-intersect, and shrink the valid range symmetrically.
    ray_origins = ray_origins + ray_directions * hit_tol
    hit_threshold = 1.0 - 2.0 * hit_tol

    out = _anyhit_backend(
        jax.lax.stop_gradient(ray_origins),
        jax.lax.stop_gradient(ray_directions),
        jax.lax.stop_gradient(mesh.triangle_vertices),
        mesh.mask,
        hit_threshold,
        kwargs.get("epsilon"),
        active_rays=active_rays,
    )
    return jax.lax.stop_gradient(out)


@partial(jax.custom_vjp, nondiff_argnums=())
def _first_hit_helper(
    vertices: Float[Array, "num_vertices 3"],
    triangles: Int[Array, "num_triangles 3"],
    active: Bool[Array, " num_triangles"] | None,
    ray_origins: Float[Array, "num_rays 3"],
    ray_directions: Float[Array, "num_rays 3"],
) -> tuple[Int[Array, " num_rays"], Float[Array, " num_rays"]]:
    triangle_vertices = jnp.take(vertices, triangles, axis=0)
    return _closest_hit_backend(ray_origins, ray_directions, triangle_vertices, active)


def _recomputed_distance(
    vertices: Float[Array, "num_vertices 3"],
    ray_origins: Float[Array, "num_rays 3"],
    ray_directions: Float[Array, "num_rays 3"],
    hit_faces: Int[Array, " num_rays"],
    triangles: Int[Array, "num_triangles 3"],
) -> Float[Array, " num_rays"]:
    """Moeller-Trumbore ``t`` for the (frozen) hit triangle of each ray."""
    hit_tri = jnp.take(triangles, hit_faces.clip(min=0), axis=0)
    tv = jnp.take(vertices, hit_tri, axis=0)
    v0 = tv[:, 0, :]
    edge1 = tv[:, 1, :] - v0
    edge2 = tv[:, 2, :] - v0
    h = jnp.cross(ray_directions, edge2)
    det = jnp.sum(h * edge1, axis=-1)
    det = jnp.where(det == 0.0, jnp.inf, det)
    s = ray_origins - v0
    q = jnp.cross(s, edge1)
    t = jnp.sum(q * edge2, axis=-1) / det
    return jnp.where(hit_faces != -1, t, jnp.inf)


def _first_hit_fwd(vertices, triangles, active, ray_origins, ray_directions):
    out = _first_hit_helper(vertices, triangles, active, ray_origins, ray_directions)
    return out, (vertices, triangles, ray_origins, ray_directions, out[0])


def _first_hit_bwd(res, g):
    vertices, triangles, ray_origins, ray_directions, hit_faces = res
    _, grad_t = g
    grad_t = jnp.where(jnp.isfinite(grad_t), grad_t, jnp.zeros_like(grad_t))

    def f(v, ro, rd):
        return _recomputed_distance(v, ro, rd, hit_faces, triangles)

    _, vjp = jax.vjp(f, vertices, ray_origins, ray_directions)
    grad_vertices, grad_origins, grad_directions = vjp(grad_t)
    return grad_vertices, None, None, grad_origins, grad_directions


_first_hit_helper.defvjp(_first_hit_fwd, _first_hit_bwd)


def dispatch_first_triangle_hit_by_ray(
    mesh: "Mesh",
    ray_origins: Float[Array, "*batch 3"],
    ray_directions: Float[Array, "*batch 3"],
    **kwargs: Any,
) -> tuple[Int[Array, " *batch"], Float[Array, " *batch"]]:
    """Mesh-level closest-hit query with differentiable distance."""
    del kwargs
    if mesh.num_triangles == 0:
        batch = jnp.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
        return (
            jnp.full(batch, -1, dtype=jnp.int32),
            jnp.full(batch, jnp.inf, dtype=mesh.vertices.dtype),
        )

    ray_origins, ray_directions = jnp.broadcast_arrays(ray_origins, ray_directions)
    batch = ray_origins.shape[:-1]

    faces, t = _first_hit_helper(
        mesh.vertices,
        mesh.triangles,
        mesh.mask,
        ray_origins.reshape(-1, 3),
        ray_directions.reshape(-1, 3),
    )
    return jax.lax.stop_gradient(faces.reshape(batch)), t.reshape(batch)


def dispatch_triangles_visible_from_vertex(
    mesh: "Mesh",
    vertex: Float[Array, "*batch 3"],
    num_rays: int = int(1e6),
    **kwargs: Any,
) -> Bool[Array, "*batch num_triangles"]:
    """Mesh-level ray-launching visibility estimate."""
    from ..rt._scan import triangles_visible_from_vertex

    return triangles_visible_from_vertex(
        jax.lax.stop_gradient(vertex),
        jax.lax.stop_gradient(mesh.triangle_vertices),
        active_triangles=mesh.mask,
        num_rays=num_rays,
        **kwargs,
    )
