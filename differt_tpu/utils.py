"""General-purpose utilities.

Mirrors the API of ``differt.utils`` (reference: differt/src/differt/utils.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
from ._typing import Array, ArrayLike, Float, Num, PRNGKeyArray


@partial(jax.jit, static_argnames=("shape",))
def sample_points_in_bounding_box(
    bounding_box: Float[ArrayLike, "2 3"],
    shape: tuple[int, ...] = (),
    *,
    key: PRNGKeyArray,
) -> Float[Array, "*shape 3"]:
    """Sample uniform random points inside a 3D bounding box.

    Reference parity: ``differt.utils.sample_points_in_bounding_box``
    (utils.py:8-33).
    """
    bounding_box = jnp.asarray(bounding_box)
    lo = bounding_box[0, :]
    hi = bounding_box[1, :]
    u = jax.random.uniform(key, shape=(*shape, 3), dtype=lo.dtype)
    return lo + u * (hi - lo)


@jax.jit
def safe_divide(
    num: Num[ArrayLike, " *#batch"],
    den: Num[ArrayLike, " *#batch"],
) -> Num[Array, " *batch"]:
    """Elementwise division that returns 0 where the denominator is 0.

    Reference parity: ``differt.utils.safe_divide`` (utils.py:36-67).

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.utils import safe_divide
        >>> safe_divide(jnp.array([1.0, 2.0, 3.0]), jnp.array([2.0, 0.0, 1.0])).tolist()
        [0.5, 0.0, 3.0]
    """
    num = jnp.asarray(num)
    den = jnp.asarray(den)
    zero = den == 0
    den_safe = jnp.where(zero, jnp.ones_like(den), den)
    out = num / den_safe
    return jnp.where(zero, jnp.zeros_like(out), out)


@jax.jit
def smoothing_function(
    x: Float[ArrayLike, " *#batch"],
    /,
    smoothing_factor: Float[ArrayLike, " *#batch"] = 1.0,
) -> Float[Array, " *batch"]:
    r"""Smooth approximation of the Heaviside step: ``sigmoid(x * alpha)``.

    This is the differentiable-RT relaxation used to replace hard hit/validity
    tests with soft confidence values (reference: utils.py:70-89; per the
    fully-eucap2024 technique).

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.utils import smoothing_function
        >>> float(smoothing_function(jnp.array(0.0)))
        0.5
        >>> bool(smoothing_function(jnp.array(4.0), 10.0) > 0.99)
        True
    """
    return jax.nn.sigmoid(jnp.asarray(x) * smoothing_factor)


# --- Component-wise (structure-of-arrays) 3-vector helpers. -----------------
#
# The EM pipelines carry every 3-vector as an (x, y, z) tuple of
# batch-shaped arrays, so elementwise work on large path batches never
# touches a tiny trailing axis of size 3; these are the shared primitives.


def dot3(a, b):
    """Dot product of component-tuple 3-vectors."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    """Cross product of component-tuple 3-vectors."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def normalize3(a):
    """Zero-safe normalize (parity with ``geometry.normalize``).

    The square root only ever sees a positive argument, so the gradient of
    a zero vector is zero instead of ``0 * inf = nan`` (which would poison
    a whole coherent sum through the masked-out paths).
    """
    sq = dot3(a, a)
    zero = sq == 0.0
    safe = jnp.sqrt(jnp.where(zero, 1.0, sq))
    return tuple(comp / safe for comp in a), jnp.where(zero, 0.0, safe)


def spherical3(k):
    """Component-wise ``em.spherical_basis`` (same values)."""
    x, y, z = k
    s_sq = x * x + y * y
    degenerate = s_sq < 1e-12
    s = jnp.sqrt(jnp.where(degenerate, 1.0, s_sq))
    cos_p = jnp.where(degenerate, 1.0, x / s)
    sin_p = jnp.where(degenerate, 0.0, y / s)
    s_out = jnp.where(degenerate, 0.0, s)
    zeros = jnp.zeros_like(s)
    theta_hat = (z * cos_p, z * sin_p, -s_out)
    phi_hat = (-sin_p, cos_p, zeros)
    return theta_hat, phi_hat


def perpendicular3(u):
    """Component-wise ``geometry.perpendicular_vector`` (same branch rule)."""
    ux, uy, uz = u
    zeros = jnp.zeros_like(ux)
    pick_a = jnp.abs(ux) > jnp.abs(uy)
    cand = (
        jnp.where(pick_a, -uy, zeros),
        jnp.where(pick_a, ux, -uz),
        jnp.where(pick_a, zeros, uy),
    )
    return normalize3(cross3(u, cand))[0]


def sp_directions3(k_i, k_r, normal):
    """Component-wise ``em.sp_directions`` (same normal-incidence fallback)."""
    e_i_s, norm = normalize3(cross3(k_i, normal))
    perp = perpendicular3(k_i)
    degenerate = norm == 0.0
    e_i_s = tuple(jnp.where(degenerate, p, e) for p, e in zip(perp, e_i_s))
    e_i_p = normalize3(cross3(e_i_s, k_i))[0]
    e_r_p = normalize3(cross3(e_i_s, k_r))[0]
    return (e_i_s, e_i_p), (e_i_s, e_r_p)


def gather_columns(table, idx):
    """Row-gather from a ``[T, C]`` table, returned as C batch arrays.

    Output layout is ``[C, *batch]``: component arrays in the batch layout
    the EM pipelines carry.
    """
    out = jnp.take(table, idx, axis=0)
    return jnp.moveaxis(out, -1, 0)


def unpack_vertices3(vertices, valid):
    """Unpack ``[*batch, L, 3]`` path vertices into per-(point, axis) arrays.

    Invalid entries are replaced by a straight dummy path (x = point index)
    so downstream normalize/grad stay finite; callers re-zero via the mask.
    """
    num_points = vertices.shape[-2]
    v_soa = jnp.moveaxis(vertices, (-2, -1), (0, 1))
    return [
        [
            jnp.where(valid, v_soa[l, axis], float(l) if axis == 0 else 0.0)
            for axis in range(3)
        ]
        for l in range(num_points)
    ]
