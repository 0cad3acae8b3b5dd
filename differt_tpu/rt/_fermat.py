"""Fermat-principle path solver (native implementation).

Finds the minimum-length path touching a sequence of *linear objects*
(each a point plus 0+ spanning vectors: an edge has one vector, a plane has
two — zero-padded to a common ``num_dims``). Handles **diffraction** (edges)
as well as reflection (planes), unlike the image method.

The reference delegates this to the external ``fpt-jax`` package
(differt/src/differt/geometry/_solver_fermat.py:11-182); here the minimizer
is implemented in-house, device-first:

- The objective ``L(x) = sum_i |p_{i+1}(x) - p_i(x)|`` is convex in the
  object-local coordinates ``x`` (each ``p`` is affine in ``x``), so a
  damped Newton method with matrix-free conjugate-gradient solves and a
  halving line search converges in a handful of ``lax.scan`` steps.
- Gradients are computed either by unrolling or via the implicit function
  theorem (``implicit_diff=True``): at the optimum ``g(x*, theta) = 0``, so
  the VJP solves ``H u = cotangent`` (CG, matrix-free HVP) and propagates
  ``-u^T dg/dtheta`` — O(1) memory in the number of solver steps.
"""

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Float

from ..geometry._vectors import orthogonal_basis

_EPS = 1e-12


def _path_points(
    x: Float[Array, "num_objects num_dims"],
    object_origins: Float[Array, "num_objects 3"],
    object_vectors: Float[Array, "num_objects num_dims 3"],
) -> Float[Array, "num_objects 3"]:
    return object_origins + jnp.einsum(
        "nd,ndk->nk", x, object_vectors, precision=jax.lax.Precision.HIGHEST
    )


def _total_length(
    x: Float[Array, "num_objects num_dims"],
    from_vertex: Float[Array, "3"],
    to_vertex: Float[Array, "3"],
    object_origins: Float[Array, "num_objects 3"],
    object_vectors: Float[Array, "num_objects num_dims 3"],
) -> Float[Array, ""]:
    points = _path_points(x, object_origins, object_vectors)
    full = jnp.concatenate(
        (from_vertex[None, :], points, to_vertex[None, :]), axis=0
    )
    segments = jnp.diff(full, axis=0)
    # Smooth (eps-regularized) norm keeps gradients finite at coincident
    # points, which otherwise break the Newton iteration.
    lengths = jnp.sqrt(jnp.sum(segments * segments, axis=-1) + _EPS)
    return jnp.sum(lengths)


def _solve_single(
    from_vertex: Float[Array, "3"],
    to_vertex: Float[Array, "3"],
    object_origins: Float[Array, "num_objects 3"],
    object_vectors: Float[Array, "num_objects num_dims 3"],
    steps: int,
    linesearch_steps: int,
    cg_steps: int,
) -> Float[Array, "num_objects num_dims"]:
    """Damped-Newton minimization of the path length, returning ``x*``."""
    num_objects, num_dims = object_vectors.shape[:2]

    def loss(x: Array) -> Array:
        return _total_length(
            x, from_vertex, to_vertex, object_origins, object_vectors
        )

    def hvp(x: Array, v: Array) -> Array:
        return jax.jvp(jax.grad(loss), (x,), (v,))[1]

    damping = 1e-6

    def newton_step(x: Array, _: None) -> tuple[Array, None]:
        g = jax.grad(loss)(x)

        def matvec(v: Array) -> Array:
            return hvp(x, v) + damping * v

        direction, _ = jax.scipy.sparse.linalg.cg(matvec, g, maxiter=cg_steps)
        direction = jnp.where(jnp.isfinite(direction), direction, g)

        # Halving line search: try scales 1, 1/2, ..., keep the best.
        scales = 0.5 ** jnp.arange(max(linesearch_steps, 1), dtype=x.dtype)
        candidates = x - scales[:, None, None] * direction
        losses = jax.vmap(loss)(candidates)
        best = jnp.argmin(losses)
        x_new = candidates[best]
        x_new = jnp.where(losses[best] < loss(x), x_new, x)
        return x_new, None

    x0 = jnp.zeros((num_objects, num_dims), dtype=object_origins.dtype)
    x_star, _ = jax.lax.scan(newton_step, x0, None, length=steps)
    return x_star


@partial(
    jax.custom_vjp,
    nondiff_argnums=(4, 5, 6),
)
def _solve_implicit(
    from_vertex: Array,
    to_vertex: Array,
    object_origins: Array,
    object_vectors: Array,
    steps: int,
    linesearch_steps: int,
    cg_steps: int,
) -> Array:
    return _solve_single(
        jax.lax.stop_gradient(from_vertex),
        jax.lax.stop_gradient(to_vertex),
        jax.lax.stop_gradient(object_origins),
        jax.lax.stop_gradient(object_vectors),
        steps,
        linesearch_steps,
        cg_steps,
    )


def _solve_implicit_fwd(
    from_vertex, to_vertex, object_origins, object_vectors,
    steps, linesearch_steps, cg_steps,
):
    x_star = _solve_implicit(
        from_vertex, to_vertex, object_origins, object_vectors,
        steps, linesearch_steps, cg_steps,
    )
    return x_star, (x_star, from_vertex, to_vertex, object_origins, object_vectors)


def _solve_implicit_bwd(steps, linesearch_steps, cg_steps, res, cotangent):
    del steps, linesearch_steps
    x_star, from_vertex, to_vertex, object_origins, object_vectors = res

    def grad_x(x, fv, tv, oo, ov):
        return jax.grad(_total_length)(x, fv, tv, oo, ov)

    def matvec(v):
        return (
            jax.jvp(
                lambda x: grad_x(x, from_vertex, to_vertex, object_origins, object_vectors),
                (x_star,),
                (v,),
            )[1]
            + 1e-6 * v
        )

    # Implicit function theorem: dx*/dtheta = -H^{-1} dg/dtheta, so the VJP
    # pulls the cotangent through H^{-1} once, then through dg/dtheta.
    u, _ = jax.scipy.sparse.linalg.cg(matvec, cotangent, maxiter=cg_steps)
    u = jnp.where(jnp.isfinite(u), u, jnp.zeros_like(u))

    _, vjp_theta = jax.vjp(
        lambda fv, tv, oo, ov: grad_x(x_star, fv, tv, oo, ov),
        from_vertex,
        to_vertex,
        object_origins,
        object_vectors,
    )
    grads = vjp_theta(-u)
    return grads


_solve_implicit.defvjp(_solve_implicit_fwd, _solve_implicit_bwd)


def fermat_path_on_linear_objects(
    from_vertex: Float[ArrayLike, "*#batch 3"],
    to_vertex: Float[ArrayLike, "*#batch 3"],
    object_origins: Float[ArrayLike, "*#batch num_objects 3"],
    object_vectors: Float[ArrayLike, "*#batch num_objects num_dims 3"],
    *,
    steps: int = 10,
    unroll: int | bool = 1,
    linesearch_steps: int = 8,
    unroll_linesearch: int | bool = 1,
    implicit_diff: bool = True,
    cg_steps: int | None = None,
) -> Float[Array, "*batch num_objects 3"]:
    """Minimum-length path through a sequence of linear objects.

    Objects with fewer dimensions than ``num_dims`` must pad
    ``object_vectors`` with zero vectors. Returns only the intermediate
    vertices. API parity: _solver_fermat.py:11-182 (``unroll`` arguments are
    accepted for compatibility; the scan is left rolled for XLA).
    """
    del unroll, unroll_linesearch
    from_vertex = jnp.asarray(from_vertex)
    to_vertex = jnp.asarray(to_vertex)
    object_origins = jnp.asarray(object_origins)
    object_vectors = jnp.asarray(object_vectors)

    num_objects = object_origins.shape[-2]
    if num_objects == 0 or object_vectors.shape[-2] == 0:
        batch = jnp.broadcast_shapes(
            from_vertex.shape[:-1],
            to_vertex.shape[:-1],
            object_origins.shape[:-2],
            object_vectors.shape[:-3],
        )
        dtype = jnp.result_type(
            from_vertex, to_vertex, object_origins, object_vectors
        )
        if num_objects == 0:
            return jnp.empty((*batch, 0, 3), dtype=dtype)
        return jnp.broadcast_to(object_origins, (*batch, num_objects, 3)).astype(dtype)

    if cg_steps is None:
        cg_steps = max(num_objects * object_vectors.shape[-2], 8)

    if implicit_diff:
        def solve(fv, tv, oo, ov):
            return _solve_implicit(fv, tv, oo, ov, steps, linesearch_steps, cg_steps)
    else:
        def solve(fv, tv, oo, ov):
            return _solve_single(fv, tv, oo, ov, steps, linesearch_steps, cg_steps)

    def single(fv, tv, oo, ov):
        x_star = solve(fv, tv, oo, ov)
        return _path_points(x_star, oo, ov)

    return jnp.vectorize(
        single,
        signature="(3),(3),(n,3),(n,d,3)->(n,3)",
    )(from_vertex, to_vertex, object_origins, object_vectors)


def fermat_path_on_planar_mirrors(
    from_vertex: Float[ArrayLike, "*#batch 3"],
    to_vertex: Float[ArrayLike, "*#batch 3"],
    mirror_vertices: Float[ArrayLike, "*#batch num_mirrors 3"],
    mirror_normals: Float[ArrayLike, "*#batch num_mirrors 3"],
    **kwargs: Any,
) -> Float[Array, "*batch num_mirrors 3"]:
    """Fermat variant of :func:`image_method` on planar mirrors.

    API parity: _solver_fermat.py:185-301.

    Examples:
        The minimal-length ground bounce between two symmetric points
        reflects at the midpoint below them:

        >>> import jax.numpy as jnp
        >>> from differt_tpu.rt import fermat_path_on_planar_mirrors
        >>> point = fermat_path_on_planar_mirrors(
        ...     jnp.array([-1.0, 0.0, 1.0]),
        ...     jnp.array([1.0, 0.0, 1.0]),
        ...     jnp.array([[0.0, 0.0, 0.0]]),
        ...     jnp.array([[0.0, 0.0, 1.0]]),
        ... )
        >>> bool(jnp.allclose(point[0], jnp.zeros(3), atol=1e-3))
        True
    """
    mirror_normals = jnp.asarray(mirror_normals)
    d1, d2 = orthogonal_basis(mirror_normals)
    return fermat_path_on_linear_objects(
        from_vertex,
        to_vertex,
        mirror_vertices,
        jnp.stack((d1, d2), axis=-2),
        **kwargs,
    )
