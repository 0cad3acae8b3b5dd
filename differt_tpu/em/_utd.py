"""Uniform Theory of Diffraction (UTD) coefficients.

Reference parity: differt/src/differt/em/_utd.py, which implements the
distance parameter ``L_i`` and transition function ``F`` but leaves
``diffraction_coefficients`` as ``NotImplementedError`` (em/_utd.py:225-302).
Here the McNamara D1..D4 wedge coefficients are fully implemented, following
McNamara, "Introduction to the Uniform Geometrical Theory of Diffraction",
ch. 6 (eqs. 6.21-6.29), with an optional Luebbers-style heuristic extension
to finitely-conducting wedges via per-face reflection coefficients.
"""

from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp
import jax.scipy.special as jsp
from .._typing import Array, ArrayLike, Complex, Float


@jax.jit
def _cot(x: Float[Array, " *batch"]) -> Float[Array, " *batch"]:
    return 1.0 / jnp.tan(x)


@partial(jax.jit, static_argnames=("mode",))
def _n_plus_minus(
    beta: Float[ArrayLike, " *#batch"],
    n: Float[ArrayLike, " *#batch"],
    mode: Literal["+", "-"],
) -> Float[Array, " *batch"]:
    """Integer ``N+-`` closest to satisfying ``2 pi n N - beta = +-pi``."""
    sign = 1.0 if mode == "+" else -1.0
    return jnp.round((jnp.asarray(beta) + sign * jnp.pi) / (2.0 * jnp.asarray(n) * jnp.pi))


@partial(jax.jit, static_argnames=("mode",))
def _a_plus_minus(
    beta: Float[ArrayLike, " *#batch"],
    n: Float[ArrayLike, " *#batch"],
    mode: Literal["+", "-"],
) -> Float[Array, " *batch"]:
    """Angular distance measure ``a+-(beta) = 2 cos^2((2 pi n N+- - beta)/2)``."""
    big_n = _n_plus_minus(beta, n, mode)
    co = jnp.cos(0.5 * (2.0 * jnp.asarray(n) * jnp.pi * big_n - jnp.asarray(beta)))
    return 2.0 * co * co


def L_i(  # noqa: N802
    s_d: Float[ArrayLike, " *#batch"],
    sin_2_beta_0: Float[ArrayLike, " *#batch"],
    rho_1_i: Float[ArrayLike, " *#batch"] | None = None,
    rho_2_i: Float[ArrayLike, " *#batch"] | None = None,
    rho_e_i: Float[ArrayLike, " *#batch"] | None = None,
    s_i: Float[ArrayLike, " *#batch"] | None = None,
) -> Float[Array, " *batch"]:
    r"""Distance parameter of the incident shadow boundary.

    Plane-wave incidence by default (``L = s^d sin^2(beta_0)``), spherical
    when ``s_i`` is passed, general astigmatic when all three ``rho`` radii
    are passed. Reference parity: em/_utd.py:42-160.
    """
    radii = (rho_1_i, rho_2_i, rho_e_i)
    all_none = all(x is None for x in radii)
    all_set = all(x is not None for x in radii)
    if s_i is not None and not all_none:
        msg = (
            "If 's_i' is provided, then 'rho_1_i', 'rho_2_i', and 'rho_e_i' "
            "must be left to 'None'."
        )
        raise ValueError(msg)
    if not all_none and not all_set:
        msg = (
            "All three of 'rho_1_i', 'rho_2_i', and 'rho_e_i' must be "
            "provided, or left to 'None'."
        )
        raise ValueError(msg)

    s_d = jnp.asarray(s_d)
    sin_2_beta_0 = jnp.asarray(sin_2_beta_0)
    if s_i is not None:
        s_i = jnp.asarray(s_i)
        return (s_d * s_i) * sin_2_beta_0 / (s_d + s_i)
    if all_none:
        return s_d * sin_2_beta_0
    rho_1_i = jnp.asarray(rho_1_i)
    rho_2_i = jnp.asarray(rho_2_i)
    rho_e_i = jnp.asarray(rho_e_i)
    return (
        (s_d * (rho_e_i + s_d) * rho_1_i * rho_2_i)
        / (rho_e_i * (rho_1_i + s_d) * (rho_2_i + s_d))
    ) * sin_2_beta_0


@jax.jit
def F(z: Float[ArrayLike, " *batch"]) -> Complex[Array, " *batch"]:  # noqa: N802
    r"""UTD transition function, via Fresnel integrals.

    ``F(x) = 2j sqrt(x) e^{jx} int_sqrt(x)^inf e^{-ju^2} du``
    (McNamara eq. 4.72). Reference parity: em/_utd.py:163-222.

    Examples:
        ``F`` approaches 1 for large arguments (no transition-region
        correction far from shadow boundaries):

        >>> import jax.numpy as jnp
        >>> from differt_tpu.em import F
        >>> bool(jnp.abs(F(jnp.array(100.0)) - 1.0) < 1e-2)
        True
    """
    z = jnp.asarray(z)
    factor = jnp.sqrt(jnp.pi / 2)
    sqrt_z = jnp.sqrt(z)
    s, c = jsp.fresnel(sqrt_z / factor)
    return 2j * sqrt_z * jnp.exp(1j * z) * (factor * ((1 - 1j) / 2 - c + 1j * s))


@jax.jit
def diffraction_coefficients(
    k: Float[ArrayLike, " *#batch"],
    n: Float[ArrayLike, " *#batch"],
    phi_i: Float[ArrayLike, " *#batch"],
    phi_d: Float[ArrayLike, " *#batch"],
    sin_beta_0: Float[ArrayLike, " *#batch"],
    length_i: Float[ArrayLike, " *#batch"],
    length_r_o: Float[ArrayLike, " *#batch"] | None = None,
    length_r_n: Float[ArrayLike, " *#batch"] | None = None,
    r_o: Complex[ArrayLike, " *#batch"] | tuple | None = None,
    r_n: Complex[ArrayLike, " *#batch"] | tuple | None = None,
) -> tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]]:
    r"""UTD wedge diffraction coefficients ``(D_s, D_h)``.

    Implements the four-cotangent McNamara form (eqs. 6.21-6.29):

    .. math::
        D_{1,2} = -\frac{e^{-j\pi/4}}{2n\sqrt{2\pi k}\sin\beta_0}
                  \cot\Big(\frac{\pi \pm (\phi - \phi')}{2n}\Big)
                  F\big(k L^i a^\pm(\phi - \phi')\big)

    and similarly ``D_{3,4}`` with :math:`\phi + \phi'` and the reflection
    distance parameters. For a perfectly conducting wedge,
    ``D_s = D_1 + D_2 - (D_3 + D_4)`` and ``D_h = D_1 + D_2 + (D_3 + D_4)``.
    Passing per-face reflection coefficients ``r_o`` / ``r_n`` (scalars or
    arrays) applies the Luebbers heuristic for lossy wedges:
    ``D = D_1 + D_2 + R_n D_3 + R_o D_4``.

    Args:
        k: Wavenumber (rad/m).
        n: Wedge parameter (exterior angle = ``n * pi``).
        phi_i: Incidence azimuth ``phi'`` measured from the o-face,
            in ``[0, n*pi]``.
        phi_d: Diffraction azimuth ``phi`` measured from the o-face.
        sin_beta_0: Sine of the skew angle between the incident ray and the
            edge (Keller cone half-angle).
        length_i: Distance parameter for the incident boundary
            (see :func:`L_i`).
        length_r_o: Distance parameter for the o-face reflection boundary
            (defaults to ``length_i``).
        length_r_n: Distance parameter for the n-face reflection boundary
            (defaults to ``length_i``).
        r_o: Reflection coefficient of the o-face (defaults to PEC: -1 for
            soft via the combination rule).
        r_n: Reflection coefficient of the n-face.

    Returns:
        Soft and hard diffraction coefficients.
    """
    k = jnp.asarray(k)
    n = jnp.asarray(n)
    phi_i = jnp.asarray(phi_i)
    phi_d = jnp.asarray(phi_d)
    sin_beta_0 = jnp.asarray(sin_beta_0)
    length_i = jnp.asarray(length_i)
    length_r_o = length_i if length_r_o is None else jnp.asarray(length_r_o)
    length_r_n = length_i if length_r_n is None else jnp.asarray(length_r_n)

    phi_m = phi_d - phi_i  # phi minus
    phi_p = phi_d + phi_i  # phi plus

    two_n = 2.0 * n

    def cot_f_term(phi: Array, mode: str, length: Array) -> Array:
        """``cot((pi +- phi)/2n) F(k L a+-(phi))`` with the singular limit.

        At shadow/reflection boundaries the cotangent diverges while
        ``F -> 0``; their product stays finite. Near the singularity we use
        the McNamara eq. 6.32 limit
        ``n [sqrt(2 pi k L) sgn(eps) - 2 k L eps e^{j pi/4}] e^{j pi/4}``
        where ``eps = 2 n x`` and ``x`` is the (signed, wrapped) distance of
        the cotangent argument from a multiple of pi.
        """
        sign = 1.0 if mode == "+" else -1.0
        arg = (jnp.pi + sign * phi) / two_n
        # Signed distance of arg from the nearest multiple of pi.
        x = arg - jnp.pi * jnp.round(arg / jnp.pi)
        eps_m = two_n * x
        # The eq. 6.32 limit is first order in eps; at |eps| ~ 0.05 its
        # truncation error reaches ~1 dB against the exact wedge series
        # (tests/test_em_published.py), while the direct cot*F product is
        # numerically stable down to |eps| ~ 1e-4 even in float32. Keep the
        # guarded window just wide enough to cover the indeterminate core.
        singular = jnp.abs(eps_m) < 0.005

        kl = k * length
        a = _a_plus_minus(phi, n, mode)  # type: ignore[arg-type]
        safe_arg = jnp.where(singular, jnp.pi / 4, arg)
        exact = _cot(safe_arg) * F(kl * jnp.where(singular, 1.0, a))

        sgn = jnp.where(eps_m >= 0.0, 1.0, -1.0)
        exp_j_pi_4 = jnp.exp(1j * jnp.pi / 4)
        limit = (
            n
            * (jnp.sqrt(2.0 * jnp.pi * kl) * sgn - 2.0 * kl * eps_m * exp_j_pi_4)
            * exp_j_pi_4
        )
        return jnp.where(singular, limit, exact)

    d1 = cot_f_term(phi_m, "+", length_i)
    d2 = cot_f_term(phi_m, "-", length_i)
    d3 = cot_f_term(phi_p, "+", length_r_n)
    d4 = cot_f_term(phi_p, "-", length_r_o)

    factor = -jnp.exp(-1j * jnp.pi / 4) / (
        two_n * jnp.sqrt(2.0 * jnp.pi * k) * sin_beta_0
    )

    # Luebbers heuristic: per-face, per-polarization reflection
    # coefficients multiply the reflection-boundary terms. ``r_o`` / ``r_n``
    # are ``(r_s, r_p)`` pairs; None = PEC (r_s = -1, r_p = +1).
    r_o_s, r_o_p = (-1.0, 1.0) if r_o is None else r_o
    r_n_s, r_n_p = (-1.0, 1.0) if r_n is None else r_n

    d12 = d1 + d2
    d_s = (d12 + r_n_s * d3 + r_o_s * d4) * factor
    d_h = (d12 + r_n_p * d3 + r_o_p * d4) * factor
    return d_s, d_h
