"""Fresnel reflection and refraction coefficients.

Reference parity: differt/src/differt/em/_fresnel.py. The complex-safe form
``n_r cos(theta_t) = sqrt(n_r^2 + cos^2(theta_i) - 1)`` handles total
internal reflection and lossy (complex-permittivity) media uniformly.
"""

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Complex, Float, Inexact

from ..utils import safe_divide


@jax.jit
def refractive_index(
    epsilon_r: Inexact[ArrayLike, " *#batch"],
    mu_r: Inexact[ArrayLike, " *#batch"] | None = None,
) -> Inexact[Array, " *batch"]:
    r"""Refractive index ``n = sqrt(epsilon_r * mu_r)`` (mu_r defaults to 1).

    Examples:
        >>> from differt_tpu.em import refractive_index
        >>> float(refractive_index(4.0))
        2.0
    """
    epsilon_r = jnp.asarray(epsilon_r)
    return jnp.sqrt(epsilon_r if mu_r is None else epsilon_r * jnp.asarray(mu_r))


@jax.jit
def fresnel_coefficients(
    n_r: Inexact[ArrayLike, " *#batch"],
    cos_theta_i: Float[ArrayLike, " *#batch"],
) -> tuple[
    tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]],
    tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]],
]:
    r"""Fresnel ``((r_s, r_p), (t_s, t_p))`` at an interface.

    ``n_r`` is the relative refractive index (second medium over first);
    ``cos_theta_i`` the cosine of the incidence angle (absolute value taken).

    Examples:
        At normal incidence on glass (n = 1.5): ``r = (1 - n)/(1 + n) = -0.2``
        for s polarization and ``+0.2`` for p (sign convention), and
        ``t = 2/(1 + n) = 0.8``.

        >>> import jax.numpy as jnp
        >>> from differt_tpu.em import fresnel_coefficients
        >>> (r_s, r_p), (t_s, t_p) = fresnel_coefficients(1.5, jnp.array(1.0))
        >>> round(float(r_s.real), 3), round(float(r_p.real), 3)
        (-0.2, 0.2)
        >>> round(float(t_s.real), 3)
        0.8
    """
    ci = jnp.abs(jnp.asarray(cos_theta_i))  # defined for theta in [-pi/2, pi/2]
    n_r = jnp.asarray(n_r)

    # Snell: n_r sin(theta_t) = sin(theta_i), hence
    # (n_r cos(theta_t))^2 = n_r^2 - sin^2(theta_i) = n_r^2 + cos^2 - 1.
    # Promoting to complex *before* the sqrt makes TIR (negative radicand)
    # and lossy media (complex n_r) flow through the same branch cut.
    snell = n_r * n_r + ci * ci - 1.0
    ct = jnp.sqrt(snell.astype(jnp.result_type(snell, jnp.complex64)))

    def interface(incident, transmission_numerator):
        """One polarization: ((in - out)/(in + out), t_num/(in + out))."""
        return (
            safe_divide(incident - ct, incident + ct),
            safe_divide(transmission_numerator, incident + ct),
        )

    r_s, t_s = interface(ci, 2.0 * ci)
    r_p, t_p = interface(n_r * n_r * ci, 2.0 * n_r * ci)
    return (r_s, r_p), (t_s, t_p)


@jax.jit
def reflection_coefficients(
    n_r: Inexact[ArrayLike, " *#batch"],
    cos_theta_i: Float[ArrayLike, " *#batch"],
) -> tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]]:
    """Fresnel ``(r_s, r_p)`` reflection coefficients."""
    return fresnel_coefficients(n_r, cos_theta_i)[0]


@jax.jit
def refraction_coefficients(
    n_r: Inexact[ArrayLike, " *#batch"],
    cos_theta_i: Float[ArrayLike, " *#batch"],
) -> tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]]:
    """Fresnel ``(t_s, t_p)`` refraction coefficients."""
    return fresnel_coefficients(n_r, cos_theta_i)[1]


@jax.jit
def slab_reflection_coefficients(
    n_r: Complex[ArrayLike, " *#batch"],
    cos_theta_i: Float[ArrayLike, " *#batch"],
    thickness: Float[ArrayLike, " *#batch"],
    wavelength: Float[ArrayLike, " *#batch"],
) -> tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]]:
    """Reflection off a finite-thickness slab (multi-bounce interference).

    Negative ``thickness`` selects the semi-infinite (plain Fresnel) result.
    Reference parity: plugins/deepmimo.py:366-405.
    """
    n_r = jnp.asarray(n_r)
    cos_theta_i = jnp.asarray(cos_theta_i)
    thickness = jnp.asarray(thickness)
    r_s_inf, r_p_inf = reflection_coefficients(n_r, cos_theta_i)

    sin_theta_sq = 1.0 - cos_theta_i * cos_theta_i
    a = jnp.sqrt(n_r * n_r - sin_theta_sq)
    q = (2.0 * jnp.pi * thickness / wavelength) * a
    phase = jnp.exp(-2j * q)

    r_s_slab = safe_divide(r_s_inf * (1.0 - phase), 1.0 - r_s_inf * r_s_inf * phase)
    r_p_slab = safe_divide(r_p_inf * (1.0 - phase), 1.0 - r_p_inf * r_p_inf * phase)

    use_slab = thickness >= 0.0
    return (
        jnp.where(use_slab, r_s_slab, r_s_inf),
        jnp.where(use_slab, r_p_slab, r_p_inf),
    )
