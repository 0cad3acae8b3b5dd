"""EM propagation utilities: delays, polarization frames, transition matrices.

Reference parity: differt/src/differt/em/_utils.py — except that
:func:`transition_matrix` is fully implemented here (the reference raises
``NotImplementedError`` at _utils.py:305-341; the working logic lived only
inside ``deepmimo.export`` at plugins/deepmimo.py:597-638 and is promoted to
a first-class, jit- and grad-friendly API).
"""

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Complex, Float, Int

from ..geometry._vectors import normalize, path_length, perpendicular_vector
from ._constants import c
from ._fresnel import slab_reflection_coefficients


@jax.jit
def length_to_delay(
    length: Float[ArrayLike, " *#batch"],
    speed: Float[ArrayLike, " *#batch"] = c,
) -> Float[Array, " *batch"]:
    """Propagation delay (s) for the given length (m)."""
    return jnp.asarray(length) / jnp.asarray(speed)


@jax.jit
def path_delay(
    path: Float[ArrayLike, "*batch path_length 3"],
    **kwargs: Any,
) -> Float[Array, " *batch"]:
    """Propagation delay (s) of a polyline path."""
    return length_to_delay(path_length(path), **kwargs)


@jax.jit
def sp_directions(
    k_i: Float[ArrayLike, "*#batch 3"],
    k_r: Float[ArrayLike, "*#batch 3"],
    normals: Float[ArrayLike, "*#batch 3"],
) -> tuple[
    tuple[Float[Array, "*batch 3"], Float[Array, "*batch 3"]],
    tuple[Float[Array, "*batch 3"], Float[Array, "*batch 3"]],
]:
    """Local s/p polarization frames before and after a reflection.

    Returns ``((e_i_s, e_i_p), (e_r_s, e_r_p))``; at normal incidence the s
    direction degenerates and a deterministic perpendicular is used instead.
    Reference parity: _utils.py:83-264.
    """
    k_i = jnp.asarray(k_i)
    k_r = jnp.asarray(k_r)
    normals = jnp.asarray(normals)

    def unit_or(vectors: Array, fallback: Array) -> Array:
        """Normalized ``vectors``, replaced by ``fallback`` where degenerate."""
        unit, length = normalize(vectors, keepdims=True)
        return jnp.where(length == 0.0, fallback, unit)

    # s is perpendicular to the plane of incidence; at normal incidence that
    # plane is undefined and a deterministic perpendicular is used so the
    # (s, p) frame stays orthonormal (and the rotation matrices well-posed).
    s_hat = unit_or(jnp.cross(k_i, normals), perpendicular_vector(k_i))
    # p completes the right-handed (s, p, k) triad for each direction.
    return (
        (s_hat, normalize(jnp.cross(s_hat, k_i))[0]),
        (s_hat, normalize(jnp.cross(s_hat, k_r))[0]),
    )


@jax.jit
def sp_rotation_matrix(
    e_a_s: Float[ArrayLike, "*#batch 3"],
    e_a_p: Float[ArrayLike, "*#batch 3"],
    e_b_s: Float[ArrayLike, "*#batch 3"],
    e_b_p: Float[ArrayLike, "*#batch 3"],
) -> Float[Array, "*batch 2 2"]:
    """Rotation matrix mapping s/p components from basis a to basis b.

    Reference parity: _utils.py:267-302.
    """
    # The change of basis is the Gram matrix of the two frames: stack each
    # frame's (s, p) rows and contract the vector axis in one einsum (which
    # XLA lowers to a small batched matmul).
    basis_a = jnp.stack(jnp.broadcast_arrays(e_a_s, e_a_p), axis=-2)
    basis_b = jnp.stack(jnp.broadcast_arrays(e_b_s, e_b_p), axis=-2)
    return jnp.einsum(
        "...ik,...jk->...ij", basis_b, basis_a, precision=jax.lax.Precision.HIGHEST
    )


@jax.jit
def spherical_basis(
    k: Float[ArrayLike, "*batch 3"],
) -> tuple[Float[Array, "*batch 3"], Float[Array, "*batch 3"]]:
    """Spherical-frame unit vectors ``(theta_hat, phi_hat)`` for directions ``k``.

    Built algebraically (no arccos/arctan2) so gradients stay finite
    everywhere; at the exact poles the ``phi = 0`` convention is pinned
    (matching ``arctan2(0, 0) = 0``). For unit ``k``:
    ``theta_hat = (z x / s, z y / s, -s)``, ``phi_hat = (-y/s, x/s, 0)``
    with ``s = sqrt(x^2 + y^2)``. Reference parity:
    plugins/deepmimo.py:333-363 (same values, angle-free formulation).
    """
    k = jnp.asarray(k)
    x, y, z = k[..., 0], k[..., 1], k[..., 2]
    s_sq = x * x + y * y
    degenerate = s_sq < 1e-12
    s = jnp.sqrt(jnp.where(degenerate, 1.0, s_sq))
    cos_p = jnp.where(degenerate, 1.0, x / s)
    sin_p = jnp.where(degenerate, 0.0, y / s)
    s_out = jnp.where(degenerate, 0.0, s)
    theta_hat = jnp.stack((z * cos_p, z * sin_p, -s_out), axis=-1)
    phi_hat = jnp.stack((-sin_p, cos_p, jnp.zeros_like(s)), axis=-1)
    return theta_hat, phi_hat


@jax.jit
def transition_apply(
    vertices: Float[ArrayLike, "*batch path_length 3"],
    object_normals: Float[ArrayLike, "*batch path_length-2 3"],
    n_r: Complex[ArrayLike, "*batch path_length-2"],
    thickness: Float[ArrayLike, "*batch path_length-2"],
    wavelength: Float[ArrayLike, ""],
    e_theta: Complex[ArrayLike, " *batch"],
    e_phi: Complex[ArrayLike, " *batch"],
    interaction_types: Int[ArrayLike, "*batch path_length-2"] | None = None,
) -> tuple[Complex[Array, " *batch"], Complex[Array, " *batch"]]:
    """Apply the multi-bounce Jones chain to a field, component-wise.

    Same physics as :func:`transition_matrix`, but the (theta, phi) field
    components are carried as two scalar arrays and every 2x2 product is
    expanded element-wise, so every array keeps the batch shape instead of
    carrying trailing ``[..., 2, 2]`` dims.
    """
    vertices = jnp.asarray(vertices)
    object_normals = jnp.asarray(object_normals)
    n_r = jnp.asarray(n_r)
    thickness = jnp.asarray(thickness)
    e_theta = jnp.asarray(e_theta)
    e_phi = jnp.asarray(e_phi)

    order = vertices.shape[-2] - 2
    if order == 0:
        return e_theta, e_phi

    segments = jnp.diff(vertices, axis=-2)
    k, _ = normalize(segments)
    theta_hat, phi_hat = spherical_basis(k)
    k_in = k[..., :-1, :]
    k_out = k[..., 1:, :]

    (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions(k_in, k_out, object_normals)
    cos_theta_i = jnp.sum(object_normals * -k_in, axis=-1)
    r_s, r_p = slab_reflection_coefficients(n_r, cos_theta_i, thickness, wavelength)

    if interaction_types is not None:
        is_reflection = jnp.asarray(interaction_types) == 0
    else:
        is_reflection = None

    def dot(a, b):
        return jnp.sum(a * b, axis=-1)

    for b in range(order):
        th_in = theta_hat[..., b, :]
        ph_in = phi_hat[..., b, :]
        th_out = theta_hat[..., b + 1, :]
        ph_out = phi_hat[..., b + 1, :]

        # (theta, phi) -> local (s, p).
        i11 = dot(e_i_s[..., b, :], th_in)
        i12 = dot(e_i_s[..., b, :], ph_in)
        i21 = dot(e_i_p[..., b, :], th_in)
        i22 = dot(e_i_p[..., b, :], ph_in)
        f_s = r_s[..., b] * (i11 * e_theta + i12 * e_phi)
        f_p = r_p[..., b] * (i21 * e_theta + i22 * e_phi)

        # Local (s, p) -> next segment's (theta, phi).
        o11 = dot(th_out, e_r_s[..., b, :])
        o12 = dot(th_out, e_r_p[..., b, :])
        o21 = dot(ph_out, e_r_s[..., b, :])
        o22 = dot(ph_out, e_r_p[..., b, :])
        new_theta = o11 * f_s + o12 * f_p
        new_phi = o21 * f_s + o22 * f_p

        if is_reflection is not None:
            keep = is_reflection[..., b]
            new_theta = jnp.where(keep, new_theta, e_theta)
            new_phi = jnp.where(keep, new_phi, e_phi)
        e_theta, e_phi = new_theta, new_phi

    return e_theta, e_phi


@jax.jit
def transition_matrix(
    vertices: Float[ArrayLike, "*batch path_length 3"],
    object_normals: Float[ArrayLike, "*batch path_length-2 3"],
    n_r: Complex[ArrayLike, "*batch path_length-2"],
    thickness: Float[ArrayLike, "*batch path_length-2"],
    wavelength: Float[ArrayLike, ""],
    interaction_types: Int[ArrayLike, "*batch path_length-2"] | None = None,
) -> Complex[Array, "*batch 2 2"]:
    """Cumulative 2x2 Jones transition matrix of a multi-bounce path.

    Expressed in the spherical ``(theta, phi)`` bases of the first and last
    path segments: for each interaction, the field is rotated into the local
    s/p frame, multiplied by ``diag(r_s, r_p)`` (slab-aware Fresnel), rotated
    into the next segment's spherical frame, and the per-bounce matrices are
    chained along the path.

    This is the first-class version of the pipeline buried in
    ``deepmimo.export`` (plugins/deepmimo.py:597-638); the reference's own
    ``transition_matrix`` is unimplemented (em/_utils.py:305-341).

    Args:
        vertices: Full path vertices (TX, interactions..., RX).
        object_normals: Unit normal at each interaction.
        n_r: Complex refractive index at each interaction.
        thickness: Slab thickness at each interaction (negative = infinite).
        wavelength: The wavelength (m).
        interaction_types: Currently only ``REFLECTION`` (0) contributes;
            other types pass through identity (diffraction is handled by the
            UTD module).

    Returns:
        The chained 2x2 complex matrix per path.
    """
    vertices = jnp.asarray(vertices)
    object_normals = jnp.asarray(object_normals)
    n_r = jnp.asarray(n_r)
    thickness = jnp.asarray(thickness)

    segments = jnp.diff(vertices, axis=-2)
    k, _ = normalize(segments)

    order = vertices.shape[-2] - 2
    batch = jnp.broadcast_shapes(
        vertices.shape[:-2], object_normals.shape[:-2], n_r.shape[:-1]
    )
    cdtype = (
        jnp.complex128 if vertices.dtype == jnp.float64 else jnp.complex64
    )
    eye = jnp.broadcast_to(jnp.eye(2, dtype=cdtype), (*batch, 2, 2))
    if order == 0:
        return eye

    theta_hat, phi_hat = spherical_basis(k)
    k_in = k[..., :-1, :]
    k_out = k[..., 1:, :]

    (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions(k_in, k_out, object_normals)
    cos_theta_i = jnp.sum(object_normals * -k_in, axis=-1)
    r_s, r_p = slab_reflection_coefficients(
        n_r, cos_theta_i, thickness, wavelength
    )

    in_rot = sp_rotation_matrix(
        theta_hat[..., :-1, :], phi_hat[..., :-1, :], e_i_s, e_i_p
    )
    out_rot = sp_rotation_matrix(
        e_r_s, e_r_p, theta_hat[..., 1:, :], phi_hat[..., 1:, :]
    )

    zero = jnp.zeros_like(r_s)
    d = jnp.stack(
        (jnp.stack((r_s, zero), axis=-1), jnp.stack((zero, r_p), axis=-1)),
        axis=-2,
    )
    j_mat = jnp.matmul(
        out_rot.astype(cdtype),
        jnp.matmul(d, in_rot.astype(cdtype), precision=jax.lax.Precision.HIGHEST),
        precision=jax.lax.Precision.HIGHEST,
    )

    if interaction_types is not None:
        interaction_types = jnp.asarray(interaction_types)
        is_reflection = (interaction_types == 0)[..., None, None]
        j_mat = jnp.where(is_reflection, j_mat, jnp.eye(2, dtype=cdtype))

    def chain(acc: Array, idx: int) -> Array:
        return jnp.matmul(j_mat[..., idx, :, :], acc, precision=jax.lax.Precision.HIGHEST)

    total = eye
    for idx in range(order):
        total = chain(total, idx)
    return total


@partial(jax.jit, static_argnames=("dB",))
def fspl(
    d: Float[ArrayLike, " *#batch"],
    f: Float[ArrayLike, " *#batch"],
    *,
    dB: bool = False,  # noqa: N803
) -> Float[Array, " *batch"]:
    """Free-space path loss, linear or in dB.

    Examples:
        >>> from differt_tpu.em import fspl
        >>> round(float(fspl(1000.0, 2.4e9, dB=True)), 2)  # 1 km at 2.4 GHz
        100.05
    """
    d = jnp.asarray(d)
    f = jnp.asarray(f)
    if dB:
        return 20 * jnp.log10(d) + 20 * jnp.log10(f) - 147.55221677811662
    x = 4 * jnp.pi * d * f / c
    return x * x
