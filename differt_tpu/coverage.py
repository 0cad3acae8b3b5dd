"""Differentiable coverage maps — a first-class op.

The reference only composes coverage maps in notebooks (or approximates
them via MLM hashes); here ``received_power`` / ``power_map`` are official
APIs: trace paths, run the Jones-chain EM pipeline, and coherently sum the
complex channel amplitudes per TX/RX. Everything is jit-able and
differentiable — gradients flow from map pixels back to material
permittivity/conductivity, geometry vertices, and TX positions. The RX-grid
axis is embarrassingly parallel and is what
:mod:`differt_tpu.parallel` shards across chips.
"""

from typing import Any

from differt_tpu import treekit as eqx
import jax
import jax.numpy as jnp
from ._typing import Array, ArrayLike, Complex, Float

from .em import c, epsilon_0, z_0
from .em._fresnel import slab_reflection_coefficients
from .geometry import Scene, TracedPaths
from .utils import (
    cross3 as _cross3,  # noqa: F401 (re-exported for internal use)
    dot3 as _dot3,
    gather_columns as _gather_columns,
    normalize3 as _normalize3,
    safe_divide,
    sp_directions3 as _sp_directions3,
    spherical3 as _spherical3,
)


@eqx.filter_jit
def complex_amplitudes(
    paths: TracedPaths,
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    *,
    eta_r: Float[ArrayLike, " num_materials"],
    conductivity: Float[ArrayLike, " num_materials"],
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    tx_pattern=None,
) -> Complex[Array, "*batch"]:
    """Complex channel amplitude of every traced path (V polarization).

    The free-space 1/s spreading, propagation phase, per-bounce slab-aware
    Fresnel Jones chain, and the lambda/(4 pi) isotropic-antenna scaling are
    applied; invalid paths contribute 0 (weighted by the float confidence
    when soft masks are used, keeping the map differentiable through path
    validity).

    Material parameters are explicit arrays (not a table lookup) so they
    can be optimization variables.

    With ``tx_pattern`` (a :class:`differt_tpu.em.RadiationPattern`), the
    launch polarization and amplitude follow the pattern evaluated in each
    path's departure direction instead of the default unit-V-pol isotropic
    excitation. This extends the reference, whose antenna module never
    feeds its path pipeline.

    The whole pipeline is computed structure-of-arrays (every 3-vector is a
    tuple of batch-shaped components), so no array carries a trailing
    ``[path_len, 3]`` axis.
    """
    frequency = jnp.asarray(frequency)
    eta_r = jnp.asarray(eta_r)
    conductivity = jnp.asarray(conductivity)
    omega = 2.0 * jnp.pi * frequency
    n_complex = jnp.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))
    wavelength = c / frequency
    if thickness is None:
        thickness = jnp.full(eta_r.shape, -1.0)
    else:
        thickness = jnp.asarray(thickness)

    # Degenerate paths may carry non-finite vertices (parallel-mirror
    # image-method infinities); normalize at zero length is
    # non-differentiable, and NaN * 0-weight is still NaN in the backward
    # pass. Substitute a harmless straight dummy path wherever the
    # GEOMETRY is non-finite. The substitution keys on finiteness, NOT on
    # the validity mask: with sigmoid-soft confidences a sub-threshold
    # path still contributes ``confidence x amplitude`` (the whole point
    # of the relaxation), so replacing its real — finite — geometry with
    # the dummy would leak dummy-path fields into the coverage map.
    num_points = paths.vertices.shape[-2]
    order = paths.order

    # Re-layout once ([*batch, L, 3] -> [L, 3, *batch]) so the (L, 3) axes
    # leave the tiled trailing positions in a single pass, then unpack into
    # per-(point, axis) batch-shaped components.
    v_soa = jnp.moveaxis(paths.vertices, (-2, -1), (0, 1))
    # "Usable geometry" = finite AND no zero-length segment: the trace
    # zeroes non-finite image-method paths, so a degenerate path arrives
    # here as identical all-zero vertices whose normalize/phase backward
    # is NaN at zero length even under a zero cotangent (0 * inf).
    diffs = v_soa[1:] - v_soa[:-1]
    seg_ok = (diffs * diffs).sum(axis=1).min(axis=0) > 1e-12
    geom_finite = jnp.isfinite(v_soa).all(axis=(0, 1)) & seg_ok
    pts = [
        [
            jnp.where(
                geom_finite, v_soa[l, axis], float(l) if axis == 0 else 0.0
            )
            for axis in range(3)
        ]
        for l in range(num_points)
    ]

    k_hats = []
    s_lens = []
    for i in range(num_points - 1):
        seg = tuple(pts[i + 1][axis] - pts[i][axis] for axis in range(3))
        k_hat, s_len = _normalize3(seg)
        k_hats.append(k_hat)
        s_lens.append(s_len)

    batch = paths.mask.shape
    if tx_pattern is None:
        e_theta = jnp.ones(batch, dtype=jnp.complex64)
        e_phi = jnp.zeros(batch, dtype=jnp.complex64)
    else:
        # Evaluate the pattern per departure direction: the amplitude-scaled
        # (s, p) field vectors projected onto the first segment's spherical
        # frame replace the unit-V-pol excitation.
        k0 = k_hats[0]
        r_eval = tx_pattern.center + jnp.stack(k0, axis=-1)
        s_vec, p_vec = tx_pattern.polarization_vectors(r_eval)
        e_vec = tuple(
            s_vec[..., axis] + p_vec[..., axis] for axis in range(3)
        )
        th0, ph0 = _spherical3(k0)
        e_theta = _dot3(e_vec, th0).astype(jnp.complex64)
        e_phi = _dot3(e_vec, ph0).astype(jnp.complex64)

    if order > 0:
        face_materials = scene.mesh.face_materials
        normals_t = scene.mesh.normals
        is_reflection = paths.interaction_types == 0

        # One [num_triangles, 6] table: normal xyz + per-face complex
        # refractive index (re, im) + thickness. A single one-hot matmul per
        # bounce replaces six multi-million-element gathers.
        if face_materials is None:
            n_r_tri = jnp.broadcast_to(n_complex[0], (normals_t.shape[0],))
            thick_tri = jnp.broadcast_to(thickness[0], (normals_t.shape[0],))
        else:
            # mode="clip": a face material index beyond the supplied
            # table (a caller passing fewer entries than the mesh has
            # materials) clamps to the last entry instead of JAX's
            # default out-of-bounds NaN fill — one NaN amplitude would
            # otherwise poison the whole coherent pixel sum.
            n_r_tri = jnp.take(n_complex, face_materials, axis=0, mode="clip")
            thick_tri = jnp.take(thickness, face_materials, axis=0, mode="clip")
        table = jnp.concatenate(
            (
                normals_t.astype(jnp.float32),
                jnp.real(n_r_tri)[:, None],
                jnp.imag(n_r_tri)[:, None],
                thick_tri[:, None].astype(jnp.float32),
            ),
            axis=-1,
        )

        for b in range(order):
            obj = paths.objects[..., b + 1]
            cols = _gather_columns(table, obj)
            normal = (cols[0], cols[1], cols[2])
            n_r_val = jax.lax.complex(cols[3], cols[4])
            thickness_val = cols[5]

            k_in = k_hats[b]
            k_out = k_hats[b + 1]
            th_in, ph_in = _spherical3(k_in)
            th_out, ph_out = _spherical3(k_out)

            (e_i_s, e_i_p), (e_r_s, e_r_p) = _sp_directions3(k_in, k_out, normal)
            cos_theta_i = -_dot3(normal, k_in)
            r_s, r_p = slab_reflection_coefficients(
                n_r_val, cos_theta_i, thickness_val, wavelength
            )

            # (theta, phi) -> local (s, p), scale, -> next (theta, phi).
            f_s = r_s * (
                _dot3(e_i_s, th_in) * e_theta + _dot3(e_i_s, ph_in) * e_phi
            )
            f_p = r_p * (
                _dot3(e_i_p, th_in) * e_theta + _dot3(e_i_p, ph_in) * e_phi
            )
            new_theta = _dot3(th_out, e_r_s) * f_s + _dot3(th_out, e_r_p) * f_p
            new_phi = _dot3(ph_out, e_r_s) * f_s + _dot3(ph_out, e_r_p) * f_p

            keep = is_reflection[..., b]
            e_theta = jnp.where(keep, new_theta, e_theta)
            e_phi = jnp.where(keep, new_phi, e_phi)

    k_last = k_hats[-1]
    theta_hat_last, _ = _spherical3(k_last)
    theta_hat_neg = _spherical3(tuple(-comp for comp in k_last))[0]
    u_coeff = _dot3(theta_hat_last, theta_hat_neg)
    a = u_coeff * e_theta

    s_tot = s_lens[0]
    for s_len in s_lens[1:]:
        s_tot = s_tot + s_len
    spreading = safe_divide(1.0, s_tot)
    phase_val = -2.0 * jnp.pi * frequency * s_tot / c
    a = a * spreading * jax.lax.complex(jnp.cos(phase_val), jnp.sin(phase_val))
    a = a * (wavelength / (4 * jnp.pi))

    weight = (
        paths.mask
        if paths.mask.dtype != jnp.bool_
        else paths.mask.astype(a.real.dtype)
    )
    # Non-finite geometry contributes nothing regardless of confidence
    # (its amplitude came from the dummy substitution above).
    weight = weight * geom_finite.astype(a.real.dtype)
    return a * weight


def received_power(
    paths: TracedPaths,
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    *,
    eta_r: Float[ArrayLike, " num_materials"],
    conductivity: Float[ArrayLike, " num_materials"],
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    coherent: bool = True,
    tx_pattern=None,
) -> Float[Array, "*reduced_batch"]:
    """Received power per TX/RX pair (coherent or non-coherent path sum).

    The last batch axis of ``paths`` (the candidate axis) is reduced.
    The frequency is traced (see :func:`power_map_chunked`): sweeps reuse
    one compiled program and the result rounds identically to the other
    coverage entry points.
    """
    return _received_power_impl(
        paths,
        scene,
        jnp.asarray(frequency),
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        coherent=coherent,
        tx_pattern=tx_pattern,
    )


@eqx.filter_jit
def _received_power_impl(
    paths: TracedPaths,
    scene: Scene,
    frequency: Float[Array, ""],
    *,
    eta_r: Float[ArrayLike, " num_materials"],
    conductivity: Float[ArrayLike, " num_materials"],
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    coherent: bool = True,
    tx_pattern=None,
) -> Float[Array, "*reduced_batch"]:
    a = complex_amplitudes(
        paths,
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        tx_pattern=tx_pattern,
    )
    if coherent:
        total = jnp.sum(a, axis=-1)
        return jnp.abs(total) ** 2 / z_0
    return jnp.sum(jnp.abs(a) ** 2, axis=-1) / z_0


def power_map(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    *,
    order: int = 1,
    eta_r: Float[ArrayLike, " num_materials"] | None = None,
    conductivity: Float[ArrayLike, " num_materials"] | None = None,
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    coherent: bool = True,
    solver: str = "exhaustive",
    with_diffraction: bool = False,
    with_scattering: bool = False,
    scattering_coefficient: Float[ArrayLike, " num_materials"] = 0.3,
    tx_pattern=None,
    mixed_signatures=None,
    **solver_kwargs: Any,
) -> Float[Array, "*batch"]:
    """Coverage map: received power for every TX/RX pair in the scene.

    Material parameters default to the built-in ITU table evaluated at
    ``frequency``; pass explicit arrays to differentiate through them.
    With ``with_diffraction=True``, first-order UTD edge diffraction
    contributions are added coherently to the reflection paths (the
    reference has no diffraction solver at all). With
    ``with_scattering=True``, single-bounce diffuse scattering power
    (Degli-Esposti effective roughness, Lambertian pattern) is added
    incoherently — scattered phases are random in nature, so its power
    adds regardless of ``coherent``; the specular amplitudes are scaled by
    ``sqrt(1 - S^2)`` per bounce so total energy is conserved.
    ``mixed_signatures`` (a sequence of interaction-type tuples, e.g.
    ``[(REFLECTION, DIFFRACTION)]``) adds mixed reflection/diffraction
    chains via the Fermat-based :class:`differt_tpu.rt.MixedPathTracer`.

    Examples:
        Ground-bounce coverage inside an open box:

        >>> import jax.numpy as jnp
        >>> from differt_tpu.coverage import power_map
        >>> from differt_tpu.geometry import Mesh, Scene
        >>> mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False)
        >>> scene = Scene(
        ...     transmitters=jnp.array([[-5.0, 0.0, 1.0]]),
        ...     mesh=mesh.set_materials("Concrete"),
        ... ).with_receivers_grid(4, 2, height=1.0)
        >>> power = power_map(scene, 2.4e9, order=1)
        >>> power.shape
        (1, 2, 4)
        >>> bool(jnp.all(power > 0.0))
        True
    """
    # Traced, so frequency sweeps re-use one compiled program (see
    # power_map_chunked).
    frequency = jnp.asarray(frequency)
    eta_r, conductivity, thickness = _resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )

    paths = scene.trace_paths(order=order, solver=solver, **solver_kwargs)
    if not with_diffraction and not with_scattering and not mixed_signatures:
        return received_power(
            paths,
            scene,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            thickness=thickness,
            coherent=coherent,
            tx_pattern=tx_pattern,
        )

    tx_batch = scene.transmitters.shape[:-1]
    rx_batch = scene.receivers.shape[:-1]
    num_tx = max(int(jnp.prod(jnp.array(tx_batch))), 1)
    num_rx = max(int(jnp.prod(jnp.array(rx_batch))), 1)

    paths_r = paths.reshape(num_tx, num_rx, -1)
    a_spec = complex_amplitudes(
        paths_r,
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        tx_pattern=tx_pattern,
    )
    if with_scattering:
        # Energy conservation (Degli-Esposti effective roughness): a surface
        # that scatters a fraction S^2 of the incident power reflects the
        # specular part with amplitude scaled by sqrt(1 - S^2). Apply the
        # per-bounce reduction to the specular chain so total power is not
        # over-counted (_scattering.py leaves this to the caller).
        s_arr = jnp.asarray(scattering_coefficient)
        obj = paths_r.objects[..., 1:-1]
        if s_arr.ndim == 0 or scene.mesh.face_materials is None:
            s_per_bounce = jnp.broadcast_to(s_arr.reshape(-1)[0], obj.shape)
        else:
            mat = jnp.take(scene.mesh.face_materials, obj, axis=0)
            s_per_bounce = jnp.take(s_arr, mat, axis=0)
        a_spec = a_spec * jnp.prod(
            jnp.sqrt(1.0 - s_per_bounce**2), axis=-1
        ).astype(a_spec.real.dtype)

    extra_amplitudes = []
    if with_diffraction or mixed_signatures:
        mesh = (
            scene.mesh
            if scene.mesh.assume_unique_vertices
            else scene.mesh.dedup_vertices()
        )
        edges, adjacent, wedge_n = mesh._diffraction_edges_info()

    if with_diffraction:
        from .rt._diffraction import diffraction_amplitudes

        diff_paths = scene.trace_diffraction_paths()
        extra_amplitudes.append(
            diffraction_amplitudes(
                diff_paths.reshape(num_tx, num_rx, -1),
                scene,
                frequency,
                edges=edges,
                adjacent_triangles=adjacent,
                wedge_n=wedge_n,
            )
        )

    if mixed_signatures:
        from .rt._mixed import MixedPathTracer, mixed_amplitudes

        tracer = MixedPathTracer()
        for signature in mixed_signatures:
            mixed_paths = tracer.trace_paths(scene, signature)
            extra_amplitudes.append(
                mixed_amplitudes(
                    mixed_paths.reshape(num_tx, num_rx, -1),
                    scene,
                    frequency,
                    edges=edges,
                    adjacent_triangles=adjacent,
                    wedge_n=wedge_n,
                    eta_r=eta_r,
                    conductivity=conductivity,
                    thickness=thickness,
                )
            )

    if coherent:
        total = a_spec.sum(axis=-1)
        for a in extra_amplitudes:
            total = total + a.sum(axis=-1)
        power = jnp.abs(total) ** 2 / z_0
    else:
        power = jnp.sum(jnp.abs(a_spec) ** 2, axis=-1) / z_0
        for a in extra_amplitudes:
            power = power + jnp.sum(jnp.abs(a) ** 2, axis=-1) / z_0

    if with_scattering:
        from .rt._scattering import scattering_amplitudes

        scatter_paths = scene.trace_scattering_paths()
        a_scatter = scattering_amplitudes(
            scatter_paths.reshape(num_tx, num_rx, -1),
            scene,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            scattering_coefficient=scattering_coefficient,
        )
        # Scattered phases are random surface noise: power adds incoherently.
        power = power + jnp.sum(jnp.abs(a_scatter) ** 2, axis=-1) / z_0

    return power.reshape(*tx_batch, *rx_batch)


def _resolve_materials(scene, frequency, eta_r, conductivity, thickness):
    """Default material arrays from the ITU table at ``frequency``."""
    from .em import materials as itu_materials

    if eta_r is None or conductivity is None:
        names = scene.mesh.material_names or ("Vacuum",)
        eta_r = jnp.array([
            itu_materials[name].relative_permittivity(frequency) for name in names
        ])
        conductivity = jnp.array([
            itu_materials[name].conductivity(frequency) for name in names
        ])
        thickness = jnp.array([
            itu_materials[name].thickness
            if itu_materials[name].thickness is not None
            else -1.0
            for name in names
        ])
    return jnp.asarray(eta_r), jnp.asarray(conductivity), thickness


@eqx.filter_jit
def _coverage_tile(
    scene: Scene,
    tx: Float[Array, "num_tx 3"],
    rx_tile: Float[Array, "rx_chunk 3"],
    cand_chunk: Array,
    itype_chunk: Array,
    chunk_valid: Array,
    frequency: Float[Array, ""],
    eta_r: Float[Array, " num_materials"],
    conductivity: Float[Array, " num_materials"],
    thickness: Float[Array, " num_materials"] | None,
    tx_pattern,
    coherent: bool,
    batch_size: int | None,
    smoothing_factor: Float[Array, ""] | None = None,
) -> Complex[Array, "num_tx rx_chunk"] | Float[Array, "num_tx rx_chunk"]:
    """One (RX tile, candidate chunk) step of :func:`power_map_chunked`.

    Module-level (stable jit identity) on purpose: a per-call closure would
    capture the material arrays as jaxpr constants and force a full XLA
    recompile of the fused trace+EM graph on every ``power_map_chunked``
    invocation — measured at 20-120 s per compile at city scale.

    With a ``smoothing_factor``, the validity checks become sigmoid-soft
    (the fully-eucap2024 relaxation) and each path's amplitude is weighted
    by its float confidence — gradients then flow through path EXISTENCE,
    recovering the hard-mask validity-jump term (PERF.md, "Hard-mask
    gradients at city scale").
    """
    from .rt._solvers import trace_path_candidates

    import differt_tpu.treekit as tk

    paths = trace_path_candidates(
        scene.mesh,
        tx,
        rx_tile,
        cand_chunk,
        interaction_types=itype_chunk,
        batch_size=batch_size,
        smoothing_factor=smoothing_factor,
    )
    if paths.mask.dtype == jnp.bool_:
        mask = paths.mask & chunk_valid
    else:  # soft confidence masks: weight, don't bitwise-and
        mask = paths.mask * chunk_valid.astype(paths.mask.dtype)
    paths = tk.tree_at(lambda p: p.mask, paths, mask)
    a = complex_amplitudes(
        paths,
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        tx_pattern=tx_pattern,
    )
    if coherent:
        return a.sum(axis=-1)
    return (jnp.abs(a) ** 2).sum(axis=-1)


def power_map_chunked(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    *,
    order: int = 1,
    eta_r: Float[ArrayLike, " num_materials"] | None = None,
    conductivity: Float[ArrayLike, " num_materials"] | None = None,
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    coherent: bool = True,
    solver: Any = "exhaustive",
    path_candidates: Any = None,
    candidate_chunk: int = 4096,
    rx_chunk: int = 4096,
    tx_pattern=None,
    batch_size: int | None = 512,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
) -> Float[Array, "*batch"]:
    """Coverage map streamed through fixed-size device buffers.

    :func:`power_map` materializes the full
    ``[num_tx, num_rx, num_candidates]`` amplitude array — fine for small
    scenes, impossible at city scale (10^5 RX x 10^5+ candidates). This
    variant tiles BOTH axes: candidates are processed ``candidate_chunk``
    at a time (per RX tile of ``rx_chunk``), accumulating the complex path
    sum (``coherent=True``) or the power sum per pixel, so device memory
    is O(candidate_chunk * rx_chunk) regardless of the scene. The compute
    per tile is one jit-compiled trace + Jones-chain step whose shapes
    never change (padded final tiles are masked), so everything runs as
    one cached XLA/Pallas program per tile.

    ``path_candidates`` overrides candidate generation (e.g. a
    visibility-pruned set from :class:`differt_tpu.rt.HybridPathTracer`);
    otherwise ``solver`` ("exhaustive"/"hybrid" or an instance) generates
    them. The reference's analogue is host-side chunked iteration
    (_solvers.py:850-934, graph.rs:77-116); here chunks are decoded and
    traced without leaving the device.
    """
    from .rt._solvers import _SOLVER_REGISTRY

    # Trace the frequency: a Python float would be a STATIC argument of
    # the jitted tile step, so a frequency sweep (or a benchmark varying
    # the frequency between reps) would recompile the whole pipeline for
    # every distinct value. As a 0-d array it is an ordinary traced operand.
    frequency = jnp.asarray(frequency)
    eta_r, conductivity, thickness = _resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )

    tx = scene.transmitters.reshape(-1, 3)
    rx_all = scene.receivers.reshape(-1, 3)
    tx_batch = scene.transmitters.shape[:-1]
    rx_batch = scene.receivers.shape[:-1]

    # The tile step only needs the mesh (and materials); strip the
    # receiver grid so its (possibly 10^6-point) array is not hashed and
    # threaded through every per-tile jit call.
    import differt_tpu.treekit as tk

    scene_tile = tk.tree_at(
        lambda s: s.receivers, scene, jnp.zeros((0, 3), rx_all.dtype)
    )

    if path_candidates is None:
        solver_obj = (
            _SOLVER_REGISTRY[solver]() if isinstance(solver, str) else solver
        )
        candidates, itypes = solver_obj.generate_path_candidates(scene, order)
    else:
        candidates = jnp.asarray(path_candidates)
        itypes = jnp.zeros_like(candidates, dtype=jnp.int32)

    num_candidates = candidates.shape[0]
    candidate_chunk = min(candidate_chunk, max(num_candidates, 1))
    pad_c = (-num_candidates) % candidate_chunk
    if pad_c:
        candidates = jnp.concatenate(
            (candidates, jnp.broadcast_to(candidates[:1], (pad_c, candidates.shape[1]))),
            axis=0,
        )
        itypes = jnp.concatenate(
            (itypes, jnp.broadcast_to(itypes[:1], (pad_c, itypes.shape[1]))), axis=0
        )

    num_rx = rx_all.shape[0]
    rx_chunk = min(rx_chunk, max(num_rx, 1))

    # Spatially-compact RX tiles: Morton-order the receivers so each chunk
    # is a square-ish block instead of a long raster strip. Narrow RX
    # bundles let the blockage kernel's box tests skip more of the mesh;
    # the output is scattered back to input order.
    rx_perm = None
    if num_rx > rx_chunk:
        from .geometry._morton import morton_perm_points

        rx_perm = morton_perm_points(rx_all)
        rx_all = jnp.take(rx_all, rx_perm, axis=0)

    pad_r = (-num_rx) % rx_chunk
    if pad_r:
        rx_all = jnp.concatenate(
            (rx_all, jnp.broadcast_to(rx_all[:1], (pad_r, 3))), axis=0
        )

    num_chunks = candidates.shape[0] // candidate_chunk
    out_tiles = []
    for r0 in range(0, rx_all.shape[0], rx_chunk):
        rx_tile = rx_all[r0 : r0 + rx_chunk]
        acc = None
        for c0 in range(num_chunks):
            lo = c0 * candidate_chunk
            chunk_valid = (
                jnp.arange(lo, lo + candidate_chunk) < num_candidates
            )
            part = _coverage_tile(
                scene_tile,
                tx,
                rx_tile,
                candidates[lo : lo + candidate_chunk],
                itypes[lo : lo + candidate_chunk],
                chunk_valid,
                frequency,
                eta_r,
                conductivity,
                thickness,
                tx_pattern,
                coherent,
                batch_size,
                None if smoothing_factor is None else jnp.asarray(smoothing_factor),
            )
            acc = part if acc is None else acc + part
        out_tiles.append(acc)

    total = jnp.concatenate(out_tiles, axis=-1)[..., :num_rx]
    if rx_perm is not None:
        total = jnp.take(total, jnp.argsort(rx_perm), axis=-1)
    power = (jnp.abs(total) ** 2 / z_0) if coherent else (total / z_0)
    return power.reshape(*tx_batch, *rx_batch)
