"""Ray-launching lattice and viewing frustum (pure JAX).

Reference parity: ``fibonacci_lattice`` (_utils.py:369-490) and
``viewing_frustum`` (_utils.py:619-927).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, DTypeLike, Float

from ._vectors import cartesian_to_spherical, spherical_to_cartesian

_INV_PHI = 2.0 / (1.0 + math.sqrt(5.0))  # golden-ratio conjugate, 1/phi

# Naively evaluating (i / phi) mod 1 in float32 destroys the azimuths of a
# large lattice: at i ~ 10^7 the product i/phi carries ~6 fractional bits, so
# the tail of the lattice collapses onto a handful of azimuth values.
#
# We restore precision with a *Fibonacci ladder*. The golden ratio satisfies
# F_m / phi = F_{m-1} - (-1/phi)^m for every Fibonacci number F_m, so
# subtracting q*F_m from the index shifts frac(i/phi) by the exactly known,
# *tiny* amount q * (-(-1/phi)^m) — the wrap defect — instead of by an
# arbitrary fraction. Reducing i down the ladder leaves a residual < 13 whose
# product with 1/phi is exact to float32, plus a sum of near-zero corrections
# that cannot lose mantissa bits. (This is the three-distance theorem at
# work: golden-ratio orbits recur almost exactly after Fibonacci steps.)
_FIB_LADDER: tuple[tuple[float, float], ...] = tuple(
    (float(fib), -((-_INV_PHI) ** m))
    for fib, m in ((832040, 30), (10946, 21), (144, 12), (13, 7))
)


def _golden_fractions(i: Float[Array, " n"]) -> Float[Array, " n"]:
    """Fractional part of ``i / phi``, accurate in float32 up to ``i < 2**24``.

    The identity ``frac(i/phi) = frac(sum_m q_m * defect_m + r/phi)`` holds
    for *any* integer decomposition ``i = sum_m q_m F_m + r``, so an
    off-by-one ``floor`` near a tile boundary only changes which (still
    exact) decomposition is used, never the result.
    """
    frac = jnp.zeros_like(i)
    for fib, defect in _FIB_LADDER:
        q = jnp.floor(i / fib)
        i = i - q * fib
        frac = frac + q * defect
    return (frac + i * _INV_PHI) % 1.0


def fibonacci_lattice(
    n: int,
    dtype: DTypeLike | None = None,
    *,
    frustum: Float[ArrayLike, "2 2"] | Float[ArrayLike, "2 3"] | None = None,
) -> Float[Array, "{n} 3"]:
    """Quasi-uniform lattice of ``n`` unit vectors on the sphere.

    With ``frustum`` given (min/max rows of ``(polar, azimuth)`` — a leading
    radial column is ignored), points are distributed uniformly in solid angle
    within the frustum. Reference parity: _utils.py:369-490.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import fibonacci_lattice
        >>> pts = fibonacci_lattice(100)
        >>> pts.shape
        (100, 3)
        >>> bool(jnp.allclose(jnp.linalg.norm(pts, axis=-1), 1.0, atol=1e-6))
        True
    """
    if n <= 0:
        raise ValueError(
            f"fibonacci_lattice needs a strictly positive size, got n={n}."
        )
    if frustum is not None:
        frustum = jnp.asarray(frustum)
        dtype = frustum.dtype
    elif dtype is not None and not jnp.issubdtype(dtype, jnp.floating):
        raise ValueError(
            f"fibonacci_lattice needs a floating dtype, got {dtype!r}."
        )

    i = jnp.arange(n, dtype=jnp.result_type(float))
    frac = _golden_fractions(i)

    if frustum is not None:
        # Interpolate uniformly in cos(polar) — equal solid angle per step —
        # and spread the quasi-random golden fractions over the azimuth span.
        polar_lo, polar_hi = frustum[:, -2]
        azim_lo, azim_hi = frustum[:, -1]
        step = i / (n - 1) if n > 1 else i
        cos_polar = jnp.cos(polar_lo) * (1.0 - step) + jnp.cos(polar_hi) * step
        polar = jnp.arccos(cos_polar)
        azimuth = azim_lo * (1.0 - frac) + azim_hi * frac
    else:
        polar = jnp.arccos(1.0 - 2.0 * i / n)
        azimuth = 2.0 * jnp.pi * frac

    xyz = spherical_to_cartesian(jnp.stack((polar, azimuth), axis=-1))
    return xyz.astype(dtype) if dtype is not None else xyz


@partial(jax.jit, static_argnames=("reduce",))
def viewing_frustum(
    viewing_vertex: Float[ArrayLike, "*#batch 3"],
    world_vertices: Float[ArrayLike, "*#batch num_vertices 3"],
    *,
    active_vertices: Bool[ArrayLike, "*#batch num_vertices"] | None = None,
    reduce: bool = False,
) -> Float[Array, "*batch 2 3"]:
    """Spherical bounding frustum of ``world_vertices`` seen from a viewer.

    Returns min/max rows of ``(r, polar, azimuth)``. Azimuth bounds are
    computed in both the [-pi, pi) and [0, 2*pi) domains and the narrower
    span wins, resolving the +-pi wraparound; if both spans exceed 270 deg the
    full circle is used. A degenerate polar band (min == max) is widened
    toward whichever pole gives the smaller span.
    Reference parity: _utils.py:619-927.
    """
    world_vertices = jnp.asarray(world_vertices)
    viewing_vertex = jnp.asarray(viewing_vertex)

    rpa = cartesian_to_spherical(world_vertices - viewing_vertex[..., None, :])
    if active_vertices is not None:
        active_vertices = jnp.asarray(active_vertices)

    r, p, a = rpa[..., 0], rpa[..., 1], rpa[..., 2]
    axis = None if reduce else -1

    r_min = jnp.min(r, axis=axis, where=active_vertices, initial=jnp.inf)
    r_max = jnp.max(r, axis=axis, where=active_vertices, initial=0.0)
    p_min = jnp.min(p, axis=axis, where=active_vertices, initial=jnp.pi)
    p_max = jnp.max(p, axis=axis, where=active_vertices, initial=0.0)

    # Azimuth: two-domain wraparound resolution.
    a_min = jnp.min(a, axis=axis, where=active_vertices, initial=jnp.pi)
    a_max = jnp.max(a, axis=axis, where=active_vertices, initial=-jnp.pi)

    two_pi = 2.0 * jnp.pi
    a_shifted = (a + two_pi) % two_pi
    a0_min = jnp.min(a_shifted, axis=axis, where=active_vertices, initial=two_pi)
    a0_max = jnp.max(a_shifted, axis=axis, where=active_vertices, initial=0.0)

    width = a_max - a_min
    width0 = a0_max - a0_min
    use_shifted = width > width0
    a_min = jnp.where(use_shifted, a0_min, a_min)
    a_max = jnp.where(use_shifted, a0_max, a_max)

    # Full-circle fallback when geometry surrounds the viewer (> 270 deg in
    # both domains).
    full_circle = jnp.minimum(width, width0) > 1.5 * jnp.pi
    a_min = jnp.where(full_circle, -jnp.pi, a_min)
    a_max = jnp.where(full_circle, jnp.pi, a_max)

    # Degenerate polar band: widen toward the pole giving the smaller span.
    p_min_dn = jnp.where(p_min == p_max, 0.0, p_min)
    p_max_up = jnp.where(p_min == p_max, jnp.pi, p_max)
    width_dn = p_max - p_min_dn
    width_up = p_max_up - p_min
    widen_up = width_dn > width_up
    p_lo = jnp.where(widen_up, p_min, p_min_dn)
    p_hi = jnp.where(widen_up, p_max_up, p_max)

    batch = () if reduce else r.shape[:-1]
    return jnp.stack((r_min, p_lo, a_min, r_max, p_hi, a_max), axis=-1).reshape(
        *batch, 2, 3
    )
