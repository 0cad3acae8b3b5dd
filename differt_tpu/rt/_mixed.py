"""Multi-bounce paths mixing specular reflections and edge diffractions.

This goes beyond the reference, which traces pure-reflection paths
(differt/src/differt/rt/_solvers.py) and ships a Fermat solver able to
handle mixed linear objects (_solver_fermat.py:11-182) but never wires
them together. Here:

- Candidates are enumerated on device from a closed-form mixed-radix
  ``index -> candidate`` decode (:func:`generate_mixed_path_candidates`),
  one base per interaction slot (``num_primitives`` for reflections,
  ``num_edges`` for diffractions) — the same sharding-friendly design as
  :mod:`differt_tpu.geometry._candidates`.
- Geometry is solved with the in-house Fermat minimizer
  (:func:`differt_tpu.rt.fermat_path_on_linear_objects`): planes contribute
  two in-plane vectors, edges one (zero-padded). At the optimum the
  specular law holds on every plane and the Keller cone condition on every
  edge, both of which are re-checked explicitly to reject non-converged or
  saddle solutions.
- Validity: reflection points inside their triangles, diffraction points
  inside their finite edge segments, specular/Keller residuals, blockage
  of every segment, minimum segment length, finiteness.
- :func:`mixed_amplitudes` composes the field: slab-aware Fresnel Jones
  blocks at reflections, UTD ``diag(D_s, D_h)`` blocks (with the Luebbers
  lossy-wedge heuristic) at diffractions, carried component-wise in the
  per-segment spherical frames. Spreading uses the astigmatic two-radii
  bookkeeping, which is exact for any number of reflections around a
  single diffraction and the standard cascade approximation for multiple
  diffractions.
"""

from collections.abc import Sequence
from functools import partial

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Complex, Float, Int

from .. import treekit as tk
from ..em._interaction_type import InteractionType
from ..geometry._paths import TracedPaths
from ..geometry._vectors import normalize, orthogonal_basis
from ..utils import safe_divide
from ._fermat import fermat_path_on_linear_objects
from ._scan import ray_intersect_any_triangle


def count_mixed_path_candidates(slot_sizes: Sequence[int]) -> int:
    """Total number of mixed candidates (full product of slot sizes).

    >>> count_mixed_path_candidates([3, 4, 2])
    24
    >>> count_mixed_path_candidates([])  # empty chain: the single LOS path
    1
    """
    total = 1
    for size in slot_sizes:
        total *= max(int(size), 0)
    return total


@partial(jax.jit, static_argnames=("slot_sizes", "start", "size"))
def _decode_mixed_range(
    slot_sizes: tuple[int, ...],
    start: int,
    size: int,
) -> Int[Array, "size num_slots"]:
    """Decode candidates ``start .. start+size`` of the slot product."""
    dtype = jnp.int32
    num_slots = len(slot_sizes)
    if num_slots == 0 or size == 0 or any(s <= 0 for s in slot_sizes):
        return jnp.zeros((max(size, 0) if all(slot_sizes) else 0, num_slots), dtype=dtype)

    # Static weights (Python big ints): weight of slot t is the product of
    # all later slot sizes.
    weights = [1] * num_slots
    for t in reversed(range(num_slots - 1)):
        weights[t] = weights[t + 1] * slot_sizes[t + 1]

    start_digits = []
    rem_start = start
    for t in range(num_slots):
        digit, rem_start = divmod(rem_start, weights[t])
        start_digits.append(digit)

    j = jnp.arange(size, dtype=dtype)
    offset_digits: list[Array] = []
    rem = j
    for t in range(num_slots):
        if weights[t] > size:
            offset_digits.append(jnp.zeros_like(j))
        else:
            w = jnp.asarray(weights[t], dtype=dtype)
            offset_digits.append(rem // w)
            rem = rem % w

    counters: list[Array] = [None] * num_slots  # type: ignore[list-item]
    carry = jnp.zeros_like(j)
    for t in reversed(range(num_slots)):
        base = max(slot_sizes[t], 1)
        total = offset_digits[t] + start_digits[t] + carry
        counters[t] = total % base
        carry = total // base
    return jnp.stack(counters, axis=-1)


def generate_mixed_path_candidates(
    slot_sizes: Sequence[int],
    *,
    start: int = 0,
    size: int | None = None,
) -> Int[Array, "size num_slots"]:
    """Enumerate (a shard of) the full product of per-slot indices on device.

    Row-major order (last slot varies fastest); ``start`` may be a Python
    big integer for sharded decoding of huge candidate spaces.
    """
    total = count_mixed_path_candidates(slot_sizes)
    if size is None:
        size = max(total - start, 0)
    return _decode_mixed_range(tuple(int(s) for s in slot_sizes), start, size)


class MixedPathTracer(tk.Module):
    """Exhaustive tracer for a fixed interaction-type signature.

    ``interactions`` is a sequence of :class:`InteractionType` values, e.g.
    ``(REFLECTION, DIFFRACTION)`` traces every reflect-then-diffract path.
    """

    epsilon: Float[ArrayLike, ""] | None = None
    """Tolerance for point-in-triangle / point-on-segment checks."""
    hit_tol: Float[ArrayLike, ""] | None = None
    """Hit-distance tolerance when testing path segments for blockage."""
    min_len: Float[ArrayLike, ""] | None = None
    """Minimal (squared) segment length for a valid path."""
    angle_tol: float = 1e-2
    """Maximal specular/Keller residual for a converged Fermat solution."""
    steps: int = 20
    """Newton steps of the Fermat minimizer."""

    def trace_paths(
        self,
        scene,
        interactions: Sequence[InteractionType | int],
        *,
        start: int = 0,
        size: int | None = None,
    ) -> TracedPaths:
        """Trace every path matching the interaction signature.

        ``objects`` stores ``[tx, slot indices..., rx]`` where reflection
        slots index mesh primitives and diffraction slots index
        ``scene.mesh.diffraction_edges``. ``start`` / ``size`` restrict the
        candidate range (multi-chip sharding).
        """
        if scene.mesh.assume_quads:
            msg = "MixedPathTracer requires a triangle mesh (assume_quads=False)."
            raise ValueError(msg)
        types = tuple(int(t) for t in interactions)
        if any(
            t not in (int(InteractionType.REFLECTION), int(InteractionType.DIFFRACTION))
            for t in types
        ):
            msg = "Only REFLECTION and DIFFRACTION interactions are supported."
            raise ValueError(msg)

        mesh = (
            scene.mesh
            if scene.mesh.assume_unique_vertices
            else scene.mesh.dedup_vertices()
        )
        edges, _adj, _n = mesh._diffraction_edges_info()
        num_edges = edges.shape[0]
        num_primitives = mesh.num_triangles

        slot_sizes = tuple(
            num_primitives if t == int(InteractionType.REFLECTION) else num_edges
            for t in types
        )
        candidates = generate_mixed_path_candidates(slot_sizes, start=start, size=size)
        return _trace_mixed(
            mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            edges,
            candidates,
            types,
            epsilon=self.epsilon,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
            angle_tol=self.angle_tol,
            steps=self.steps,
        )


@tk.filter_jit
def _trace_mixed(
    mesh,
    tx_vertices: Float[Array, "num_tx 3"],
    rx_vertices: Float[Array, "num_rx 3"],
    edges: Float[Array, "num_edges 2 3"],
    candidates: Int[Array, "num_candidates order"],
    types: tuple[int, ...],
    *,
    epsilon: Float[ArrayLike, ""] | None,
    hit_tol: Float[ArrayLike, ""] | None,
    min_len: Float[ArrayLike, ""] | None,
    angle_tol: float,
    steps: int,
) -> TracedPaths:
    dtype = tx_vertices.dtype
    if epsilon is None:
        epsilon = 10.0 * jnp.finfo(dtype).eps
    if min_len is None:
        min_len = 10.0 * jnp.finfo(dtype).eps
    epsilon = jnp.asarray(epsilon)
    min_len = jnp.asarray(min_len)

    num_tx = tx_vertices.shape[0]
    num_rx = rx_vertices.shape[0]
    num_candidates, order = candidates.shape
    is_reflection = [t == int(InteractionType.REFLECTION) for t in types]

    # Per-slot linear objects: planes get the (d1, d2) in-plane basis of the
    # triangle, edges their (unnormalized) direction vector plus a zero pad.
    origins = []
    vectors = []
    for b in range(order):
        idx = candidates[:, b]
        if is_reflection[b]:
            tri = jnp.take(mesh.triangle_vertices, idx, axis=0)
            origin = tri[:, 0, :]
            normal = jnp.take(mesh.normals, idx, axis=0)
            d1, d2 = orthogonal_basis(normal)
            vecs = jnp.stack((d1, d2), axis=-2)
        else:
            e = jnp.take(edges, idx, axis=0)
            origin = e[:, 0, :]
            ev = e[:, 1, :] - e[:, 0, :]
            vecs = jnp.stack((ev, jnp.zeros_like(ev)), axis=-2)
        origins.append(origin)
        vectors.append(vecs)
    object_origins = jnp.stack(origins, axis=-2)  # [cand, order, 3]
    object_vectors = jnp.stack(vectors, axis=-3)  # [cand, order, 2, 3]

    points = fermat_path_on_linear_objects(
        tx_vertices[:, None, None, :],
        rx_vertices[None, :, None, :],
        object_origins,
        object_vectors,
        steps=steps,
    )  # [num_tx, num_rx, num_candidates, order, 3]

    full_paths = jnp.concatenate(
        (
            jnp.broadcast_to(
                tx_vertices[:, None, None, None, :],
                (num_tx, num_rx, num_candidates, 1, 3),
            ),
            points,
            jnp.broadcast_to(
                rx_vertices[None, :, None, None, :],
                (num_tx, num_rx, num_candidates, 1, 3),
            ),
        ),
        axis=-2,
    )
    ray_origins = full_paths[..., :-1, :]
    segments = jnp.diff(full_paths, axis=-2)
    k_hat, _ = normalize(segments)

    mask = jnp.ones((num_tx, num_rx, num_candidates), dtype=bool)
    for b in range(order):
        idx = candidates[:, b]
        p = points[..., b, :]
        k_in = k_hat[..., b, :]
        k_out = k_hat[..., b + 1, :]
        if is_reflection[b]:
            tri = jnp.take(mesh.triangle_vertices, idx, axis=0)
            # Barycentric inside-triangle test.
            e1 = tri[:, 1, :] - tri[:, 0, :]
            e2 = tri[:, 2, :] - tri[:, 0, :]
            d = p - tri[:, 0, :]
            e11 = jnp.sum(e1 * e1, axis=-1)
            e22 = jnp.sum(e2 * e2, axis=-1)
            e12 = jnp.sum(e1 * e2, axis=-1)
            d1 = jnp.sum(d * e1, axis=-1)
            d2 = jnp.sum(d * e2, axis=-1)
            det = e11 * e22 - e12 * e12
            u = safe_divide(d1 * e22 - d2 * e12, det)
            v = safe_divide(d2 * e11 - d1 * e12, det)
            inside = (u >= -epsilon) & (v >= -epsilon) & (u + v <= 1.0 + epsilon)
            # Specular residual: the Fermat optimum must satisfy the
            # reflection law; saddle/non-converged solutions are rejected.
            normal = jnp.take(mesh.normals, idx, axis=0)
            reflected = (
                k_in - 2.0 * jnp.sum(k_in * normal, axis=-1, keepdims=True) * normal
            )
            residual = jnp.linalg.norm(k_out - reflected, axis=-1)
            # Same-side: TX-side and RX-side vertices on one side of the plane.
            prev_side = jnp.sum((full_paths[..., b, :] - p) * normal, axis=-1)
            next_side = jnp.sum((full_paths[..., b + 2, :] - p) * normal, axis=-1)
            same_side = prev_side * next_side > 0.0
            mask = mask & inside & (residual < angle_tol) & same_side
        else:
            e = jnp.take(edges, idx, axis=0)
            ev = e[:, 1, :] - e[:, 0, :]
            ev_sq = jnp.sum(ev * ev, axis=-1)
            t = safe_divide(jnp.sum((p - e[:, 0, :]) * ev, axis=-1), ev_sq)
            margin = 1e-4
            on_segment = (t > margin) & (t < 1.0 - margin)
            # Keller cone: equal angles with the edge direction.
            e_hat = normalize(ev)[0]
            keller = (
                jnp.abs(
                    jnp.sum(k_in * e_hat, axis=-1) - jnp.sum(k_out * e_hat, axis=-1)
                )
                < angle_tol
            )
            mask = mask & on_segment & keller

        # Degenerate candidates: consecutive same-kind slots with equal index.
        if b > 0 and is_reflection[b] == is_reflection[b - 1]:
            mask = mask & (candidates[:, b] != candidates[:, b - 1])

    blocked = mesh.ray_intersect_any_triangle(
        ray_origins, segments, hit_tol=hit_tol
    ).any(axis=-1)
    seg_sq = jnp.sum(segments * segments, axis=-1)
    too_small = (seg_sq < min_len).any(axis=-1)
    is_finite = jnp.isfinite(full_paths).all(axis=(-1, -2))
    full_paths = jnp.where(
        is_finite[..., None, None], full_paths, jnp.zeros_like(full_paths)
    )
    mask = mask & ~blocked & ~too_small & is_finite

    obj_dtype = jnp.int32
    tx_objects = jnp.broadcast_to(
        jnp.arange(num_tx, dtype=obj_dtype)[:, None, None, None],
        (num_tx, num_rx, num_candidates, 1),
    )
    rx_objects = jnp.broadcast_to(
        jnp.arange(num_rx, dtype=obj_dtype)[None, :, None, None],
        (num_tx, num_rx, num_candidates, 1),
    )
    mid_objects = jnp.broadcast_to(
        candidates.astype(obj_dtype), (num_tx, num_rx, num_candidates, order)
    )
    objects = jnp.concatenate((tx_objects, mid_objects, rx_objects), axis=-1)
    interaction_types = jnp.broadcast_to(
        jnp.asarray(types, dtype=jnp.int32), (num_tx, num_rx, num_candidates, order)
    )
    return TracedPaths(
        full_paths, objects, mask=mask, interaction_types=interaction_types
    )


def mixed_amplitudes(
    paths: TracedPaths,
    scene,
    frequency: Float[ArrayLike, ""],
    *,
    edges: Float[Array, "num_edges 2 3"],
    adjacent_triangles: Int[Array, "num_edges 2"],
    wedge_n: Float[Array, " num_edges"],
    eta_r: Float[ArrayLike, " num_materials"],
    conductivity: Float[ArrayLike, " num_materials"],
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    types: "tuple[int, ...] | None" = None,
) -> Complex[Array, "*batch"]:
    """Complex channel amplitude of mixed reflection/diffraction paths (V-pol).

    The (theta, phi) field components are carried component-wise through the
    chain: slab-aware Fresnel blocks at reflections, UTD ``diag(D_s, D_h)``
    blocks (Luebbers lossy wedges) at diffractions. Spreading uses the
    astigmatic two-radii bookkeeping — exact for paths with at most one
    diffraction (any number of planar reflections), the standard cascade
    approximation beyond.

    ``paths.interaction_types`` must be constant along the batch (one
    signature per call, as produced by :class:`MixedPathTracer`). The
    signature is a *static* quantity: it is read on the host from
    ``paths.interaction_types``, which fails under ``jit``/``vmap`` — in
    that case pass it explicitly via ``types`` (a tuple of
    :class:`InteractionType` values, one per interaction).
    """
    import numpy as np

    order = paths.order
    if types is None:
        try:
            host_types = np.asarray(paths.interaction_types)
        except Exception as exc:  # jax.errors.TracerArrayConversionError
            msg = (
                "mixed_amplitudes reads the (static) interaction signature "
                "from paths.interaction_types on the host, which is not "
                "possible under jit/vmap. Pass the signature explicitly "
                "via the `types` argument instead."
            )
            raise ValueError(msg) from exc
        types = tuple(int(t) for t in host_types.reshape(-1, order)[0])
    else:
        types = tuple(int(t) for t in types)
        if len(types) != order:
            msg = f"`types` has {len(types)} entries but paths.order is {order}."
            raise ValueError(msg)
    return _mixed_amplitudes(
        paths,
        scene,
        frequency,
        edges=edges,
        adjacent_triangles=adjacent_triangles,
        wedge_n=wedge_n,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        types=types,
    )


@tk.filter_jit
def _mixed_amplitudes(
    paths: TracedPaths,
    scene,
    frequency: Float[ArrayLike, ""],
    *,
    edges: Float[Array, "num_edges 2 3"],
    adjacent_triangles: Int[Array, "num_edges 2"],
    wedge_n: Float[Array, " num_edges"],
    eta_r: Float[ArrayLike, " num_materials"],
    conductivity: Float[ArrayLike, " num_materials"],
    thickness: Float[ArrayLike, " num_materials"] | None,
    types: tuple[int, ...],
) -> Complex[Array, "*batch"]:
    from ..em._constants import c, epsilon_0
    from ..em._fresnel import reflection_coefficients, slab_reflection_coefficients
    from ..em._utd import diffraction_coefficients
    from ..em._utils import sp_directions, spherical_basis

    frequency = jnp.asarray(frequency)
    wavelength = c / frequency
    k_wave = 2.0 * jnp.pi / wavelength
    eta_r = jnp.asarray(eta_r)
    conductivity = jnp.asarray(conductivity)
    if thickness is None:
        thickness = jnp.full(eta_r.shape, -1.0)
    else:
        thickness = jnp.asarray(thickness)
    omega = 2.0 * jnp.pi * frequency
    n_complex = jnp.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))

    order = paths.order
    valid = (
        paths.mask
        if paths.mask.dtype == jnp.bool_
        else paths.mask >= paths.confidence_threshold
    )
    path_length = paths.vertices.shape[-2]
    dummy = (
        jnp.zeros((path_length, 3))
        .at[:, 0]
        .set(jnp.arange(path_length, dtype=paths.vertices.dtype))
    )
    vertices = jnp.where(valid[..., None, None], paths.vertices, dummy)

    segments = jnp.diff(vertices, axis=-2)
    k_hat, s = normalize(segments)

    batch = paths.mask.shape
    e_theta = jnp.ones(batch, dtype=jnp.complex64)
    e_phi = jnp.zeros(batch, dtype=jnp.complex64)

    theta_hats, phi_hats = spherical_basis(k_hat)

    face_materials = scene.mesh.face_materials
    tri_centroids = scene.mesh.triangle_vertices.mean(axis=-2)
    normals_all = scene.mesh.normals

    def dot(a, b):
        return jnp.sum(a * b, axis=-1)

    # Astigmatic wavefront radii at the current interaction point; both
    # equal the traveled distance for the spherical wave off TX.
    r1 = s[..., 0]
    r2 = s[..., 0]
    spread = jnp.ones(batch, dtype=s.dtype)

    for b in range(order):
        obj = paths.objects[..., b + 1]
        k_in = k_hat[..., b, :]
        k_out = k_hat[..., b + 1, :]
        s_next = s[..., b + 1]
        th_in = theta_hats[..., b, :]
        ph_in = phi_hats[..., b, :]
        th_out = theta_hats[..., b + 1, :]
        ph_out = phi_hats[..., b + 1, :]

        if types[b] == int(InteractionType.REFLECTION):
            normal = jnp.take(normals_all, obj, axis=0)
            if face_materials is None:
                mat = jnp.zeros_like(obj)
            else:
                mat = jnp.take(face_materials, obj, axis=0).clip(min=0)
            n_r_val = jnp.take(n_complex, mat, axis=0, mode="clip")
            thick_val = jnp.take(thickness, mat, axis=0, mode="clip")
            cos_theta_i = dot(normal, -k_in)
            r_s, r_p = slab_reflection_coefficients(
                n_r_val, cos_theta_i, thick_val, wavelength
            )
            (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions(k_in, k_out, normal)
            f_s = r_s * (
                dot(e_i_s, th_in).astype(jnp.complex64) * e_theta
                + dot(e_i_s, ph_in).astype(jnp.complex64) * e_phi
            )
            f_p = r_p * (
                dot(e_i_p, th_in).astype(jnp.complex64) * e_theta
                + dot(e_i_p, ph_in).astype(jnp.complex64) * e_phi
            )
            e_theta = (
                dot(th_out, e_r_s).astype(jnp.complex64) * f_s
                + dot(th_out, e_r_p).astype(jnp.complex64) * f_p
            )
            e_phi = (
                dot(ph_out, e_r_s).astype(jnp.complex64) * f_s
                + dot(ph_out, e_r_p).astype(jnp.complex64) * f_p
            )
            # Planar mirror: both radii continue unchanged.
            spread = spread * jnp.sqrt(
                safe_divide(r1 * r2, (r1 + s_next) * (r2 + s_next))
            )
            r1 = r1 + s_next
            r2 = r2 + s_next
        else:
            edge_origin = jnp.take(edges[:, 0, :], obj, axis=0)
            edge_end = jnp.take(edges[:, 1, :], obj, axis=0)
            e_hat = normalize(edge_end - edge_origin)[0]
            n_param = jnp.take(wedge_n, obj, axis=0)
            o_face = jnp.take(adjacent_triangles[:, 0], obj, axis=0)
            n_face = jnp.take(adjacent_triangles[:, 1], obj, axis=0)
            c_o = jnp.take(tri_centroids, o_face.clip(min=0), axis=0)
            n_o = jnp.take(normals_all, o_face.clip(min=0), axis=0)

            to_c = c_o - edge_origin
            par = jnp.sum(to_c * e_hat, axis=-1, keepdims=True)
            t_o = normalize(to_c - par * e_hat)[0]
            flip = dot(jnp.cross(t_o, n_o), e_hat) < 0.0
            e_hat = jnp.where(flip[..., None], -e_hat, e_hat)

            cos_beta = dot(k_in, e_hat)
            sin_beta_0 = jnp.sqrt(jnp.clip(1.0 - cos_beta * cos_beta, 1e-12, 1.0))

            def azimuth(v, e_hat=e_hat, t_o=t_o, n_o=n_o):
                par = jnp.sum(v * e_hat, axis=-1, keepdims=True)
                perp = normalize(v - par * e_hat)[0]
                ang = jnp.arctan2(dot(perp, n_o), dot(perp, t_o))
                return jnp.where(ang < 0.0, ang + 2.0 * jnp.pi, ang)

            phi_i = azimuth(-k_in)
            phi_d = azimuth(k_out)

            # Astigmatic distance parameter (McNamara 6.25) with the edge
            # caustic radius approximated by the continued radius r2.
            length = safe_divide(
                s_next * (r2 + s_next) * r1 * r2 * sin_beta_0 * sin_beta_0,
                r2 * (r1 + s_next) * (r2 + s_next),
            )

            if face_materials is None:
                mat_o = jnp.zeros_like(obj)
                mat_n = jnp.zeros_like(obj)
            else:
                mat_o = jnp.take(face_materials, o_face.clip(min=0), axis=0).clip(min=0)
                mat_n = jnp.take(face_materials, n_face.clip(min=0), axis=0).clip(min=0)
            n_r_o = jnp.take(n_complex, mat_o, axis=0, mode="clip")
            n_r_n = jnp.take(n_complex, mat_n, axis=0, mode="clip")
            r_o = reflection_coefficients(n_r_o, jnp.abs(jnp.sin(phi_i)))
            r_n = reflection_coefficients(
                n_r_n, jnp.abs(jnp.sin(n_param * jnp.pi - phi_d))
            )

            d_s, d_h = diffraction_coefficients(
                k=k_wave,
                n=n_param,
                phi_i=phi_i,
                phi_d=phi_d,
                sin_beta_0=sin_beta_0,
                length_i=length,
                r_o=r_o,
                r_n=r_n,
            )

            phi_i_hat = normalize(jnp.cross(e_hat, k_in))[0]
            beta_i_hat = normalize(jnp.cross(phi_i_hat, k_in))[0]
            phi_d_hat = normalize(jnp.cross(e_hat, k_out))[0]
            beta_d_hat = normalize(jnp.cross(phi_d_hat, k_out))[0]

            f_beta = d_s * (
                dot(beta_i_hat, th_in).astype(jnp.complex64) * e_theta
                + dot(beta_i_hat, ph_in).astype(jnp.complex64) * e_phi
            )
            f_phi = d_h * (
                dot(phi_i_hat, th_in).astype(jnp.complex64) * e_theta
                + dot(phi_i_hat, ph_in).astype(jnp.complex64) * e_phi
            )
            e_theta = (
                dot(th_out, beta_d_hat).astype(jnp.complex64) * f_beta
                + dot(th_out, phi_d_hat).astype(jnp.complex64) * f_phi
            )
            e_phi = (
                dot(ph_out, beta_d_hat).astype(jnp.complex64) * f_beta
                + dot(ph_out, phi_d_hat).astype(jnp.complex64) * f_phi
            )
            # Edge caustic: the first radius resets at the edge.
            rho = r2
            spread = spread * jnp.sqrt(safe_divide(rho, s_next * (rho + s_next)))
            r1 = s_next
            r2 = rho + s_next

    # Receiver V-pol projection.
    k_last = k_hat[..., -1, :]
    theta_out, _ = spherical_basis(k_last)
    theta_neg = spherical_basis(-k_last)[0]
    u = dot(theta_out, theta_neg)
    a = u.astype(jnp.complex64) * e_theta

    s_tot = s.sum(axis=-1)
    a = a * spread * safe_divide(1.0, s[..., 0])
    phase_val = -k_wave * s_tot
    a = a * jax.lax.complex(jnp.cos(phase_val), jnp.sin(phase_val))
    a = a * (wavelength / (4.0 * jnp.pi))

    weight = (
        paths.mask
        if paths.mask.dtype != jnp.bool_
        else paths.mask.astype(jnp.float32)
    )
    return a * weight
