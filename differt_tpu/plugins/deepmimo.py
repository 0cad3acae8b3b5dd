"""DeepMIMO export: traced paths + scene materials -> complex channel data.

Reference parity: differt/src/differt/plugins/deepmimo.py. The per-bounce
Jones chain is delegated to the first-class
:func:`differt_tpu.em.transition_matrix` op; everything after the material
table lookup is jit-able and differentiable (the basis of differentiable
coverage maps).
"""

__all__ = ("DeepMIMO", "export")

from collections.abc import Iterable, Mapping
from dataclasses import KW_ONLY, asdict
from typing import Any, Generic, Literal, TypeVar

from differt_tpu import treekit as eqx
import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, Float, Int, Shaped

from ..em import (
    InteractionType,
    Material,
    c,
    epsilon_0,
    materials,
    spherical_basis,
    transition_apply,
    z_0,
)
from ..geometry import Scene, TracedPaths, cartesian_to_spherical, normalize
from ..utils import safe_divide

ArrayType = TypeVar("ArrayType")


def _stack_ragged(
    parts: "list[Array]",
    fill_value: Any,
    width: int,
) -> Array:
    """Join per-order arrays along the path axis (2), padding the interaction
    axis (3) of every part up to ``width`` first."""
    padded = []
    for part in parts:
        pad = [(0, 0)] * part.ndim
        pad[3] = (0, width - part.shape[3])
        padded.append(jnp.pad(part, pad, constant_values=fill_value))
    return jnp.concatenate(padded, axis=2)


class DeepMIMO(eqx.Module, Generic[ArrayType]):
    """DeepMIMO-format channel data (one entry per path).

    Reference parity: plugins/deepmimo.py:85-332.
    """

    _: KW_ONLY
    power: Float[ArrayType, "num_tx num_rx num_paths"]
    """Received power per path (dBW, 0 dBW transmitted)."""
    phase: Float[ArrayType, "num_tx num_rx num_paths"]
    """Received phase per path (degrees)."""
    delay: Float[ArrayType, "num_tx num_rx num_paths"]
    """Propagation delay per path (seconds)."""
    aoa_az: Float[ArrayType, "num_tx num_rx num_paths"]
    """Angle of arrival, azimuth (degrees)."""
    aoa_el: Float[ArrayType, "num_tx num_rx num_paths"]
    """Angle of arrival, elevation (degrees)."""
    aod_az: Float[ArrayType, "num_tx num_rx num_paths"]
    """Angle of departure, azimuth (degrees)."""
    aod_el: Float[ArrayType, "num_tx num_rx num_paths"]
    """Angle of departure, elevation (degrees)."""
    primitives: Int[ArrayType, "num_tx num_rx num_paths max_inter"] | None = None
    """Optional primitive indices along each path (-1 = none)."""
    inter: Int[ArrayType, "num_tx num_rx num_paths max_inter"] = None
    """Interaction types along each path (-1 = none)."""
    inter_pos: Float[ArrayType, "num_tx num_rx num_paths max_inter 3"] = None
    """Interaction point coordinates (m)."""
    rx_pos: Float[ArrayType, "num_rx 3"] = None
    """Receiver positions (m)."""
    tx_pos: Float[ArrayType, "num_tx 3"] = None
    """Transmitter positions (m)."""
    mask: Bool[ArrayType, "num_tx num_rx num_paths"] = None
    """Valid-path mask."""

    @property
    def num_tx(self) -> int:
        """Transmitter count."""
        return self.mask.shape[0]

    @property
    def num_rx(self) -> int:
        """Receiver count."""
        return self.mask.shape[1]

    @property
    def num_paths(self) -> int:
        """Path count."""
        return self.mask.shape[2]

    def asdict(self) -> dict[str, ArrayType]:
        """Convert to a plain dictionary."""
        return asdict(self)

    def numpy(self) -> "DeepMIMO":
        """Convert all arrays to NumPy."""
        import numpy as np

        return jax.tree.map(lambda x: np.asarray(x), self)

    def jax(self) -> "DeepMIMO[Array]":
        """Convert all arrays to JAX arrays."""
        return jax.tree.map(jnp.asarray, self)

    def sort_by_vertices(
        self,
        vertices: Float[ArrayLike, "num_tx num_rx num_paths max_inter 3"],
        interactions: Int[ArrayLike, "num_tx num_rx num_paths max_inter"],
    ) -> "DeepMIMO[Array]":
        """Reorder paths to match an external path ordering.

        For each external path (given by its interaction positions and
        types), the closest matching internal path is found and paths are
        permuted accordingly — useful for comparing against another ray
        tracer (e.g., Sionna RT) whose path order differs.
        Reference parity: plugins/deepmimo.py:160-220 (``_sort``),
        generalized to plain arrays instead of ``sionna.rt.Paths``.
        """
        vertices = jnp.asarray(vertices)
        interactions = jnp.asarray(interactions)
        if vertices.shape != self.inter_pos.shape:
            msg = (
                "External path geometry must match this dataset's shape "
                f"{self.inter_pos.shape!r}; received {vertices.shape!r}."
            )
            raise ValueError(msg)

        max_inter = self.inter.shape[-1]
        distances = jnp.linalg.norm(
            self.inter_pos.reshape(-1, 1, max_inter, 3)
            - vertices.reshape(1, -1, max_inter, 3),
            axis=3,
        )
        type_mismatch = ~(
            self.inter.reshape(-1, 1, max_inter)
            == interactions.reshape(1, -1, max_inter)
        ).all(axis=-1)
        cost = distances.sum(
            axis=2,
            initial=jnp.where(type_mismatch, jnp.inf, 0.0),
            where=self.inter.reshape(-1, 1, max_inter) != -1,
        )
        indices = cost.argmin(axis=1)

        prefix = (self.num_tx, self.num_rx, self.num_paths)

        def sort_fn(x: Array) -> Array:
            if x is None or getattr(x, "shape", ())[: len(prefix)] != prefix:
                return x
            y = x.reshape(-1, *x.shape[len(prefix):])
            return y[indices, ...].reshape(x.shape)

        return jax.tree.map(sort_fn, self.jax())

    def iter_paths(self):
        """Iterate over valid path vertex arrays grouped by interaction count."""
        from ..geometry import SizedIterator

        max_inter = self.inter.shape[-1]

        def it():
            num_interactions = jnp.min(
                jnp.broadcast_to(jnp.arange(max_inter), self.inter.shape),
                initial=max_inter,
                where=self.inter == -1,
                axis=-1,
            )
            for num in range(max_inter + 1):
                where = (self.mask & (num_interactions == num)).reshape(-1)
                tx = jnp.broadcast_to(
                    self.tx_pos[:, None, None, :],
                    (self.num_tx, self.num_rx, self.num_paths, 3),
                ).reshape(-1, 3)[where, :]
                rx = jnp.broadcast_to(
                    self.rx_pos[None, :, None, :],
                    (self.num_tx, self.num_rx, self.num_paths, 3),
                ).reshape(-1, 3)[where, :]
                mid = self.inter_pos.reshape(-1, max_inter, 3)[where, :num, :]
                yield jnp.concatenate(
                    (tx[..., None, :], mid, rx[..., None, :]), axis=-2
                )

        return SizedIterator(it(), size=max_inter + 1)

    def plot_paths(self, **kwargs: Any):
        """Plot all valid paths."""
        from ..plotting import draw_paths, reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            for paths in self.iter_paths():
                draw_paths(paths)
        return output


def _slab_tables(
    radio_materials: Mapping[str, Material],
    names: "list[str]",
    frequency: Float[ArrayLike, ""],
) -> tuple[Array, Array]:
    """Per-material complex refractive index and slab thickness tables.

    Thickness ``-1`` encodes an infinite medium (no slab model).
    """
    refraction = []
    thickness = []
    for name in names:
        material = radio_materials[name]
        eps = material.relative_permittivity(frequency) - 1j * safe_divide(
            material.conductivity(frequency), 2.0 * jnp.pi * frequency * epsilon_0
        )
        refraction.append(jnp.sqrt(eps))
        thickness.append(
            -1.0 if material.thickness is None else material.thickness
        )
    return jnp.asarray(refraction), jnp.asarray(thickness)


def _transmit_field(
    pol: Any, k_first: Float[Array, "*lanes 3"]
) -> tuple[Array, Array]:
    """Initial (theta, phi) field components for the TX polarization.

    Components are carried as two scalar arrays rather than a trailing
    ``[..., 2]`` axis, as everywhere in the EM chain.
    """
    theta_hat, phi_hat = spherical_basis(k_first)
    lanes = theta_hat.shape[:-1]
    if isinstance(pol, str):
        vertical = pol == "V"
        return (
            jnp.full(lanes, 1.0 if vertical else 0.0, dtype=complex),
            jnp.full(lanes, 0.0 if vertical else 1.0, dtype=complex),
        )
    p = jnp.asarray(pol, dtype=complex)
    return jnp.sum(p * theta_hat, axis=-1), jnp.sum(p * phi_hat, axis=-1)


def _receive_projection(
    pol: Any,
    k_last: Float[Array, "*lanes 3"],
    e_theta: Array,
    e_phi: Array,
) -> Array:
    """Project the arriving field onto the RX polarization."""
    theta_hat, phi_hat = spherical_basis(k_last)
    if isinstance(pol, str):
        # Alignment between the forward-propagation basis and the receive
        # basis, which points along -k.
        align = jnp.sum(theta_hat * spherical_basis(-k_last)[0], axis=-1)
        return align * e_theta if pol == "V" else -align * e_phi
    p = jnp.asarray(pol)
    return (
        jnp.sum(p * theta_hat, axis=-1) * e_theta
        + jnp.sum(p * phi_hat, axis=-1) * e_phi
    )


def _direction_angles_deg(k: Float[Array, "... 3"]) -> tuple[Array, Array]:
    """(azimuth, zenith) angles of unit directions, in degrees.

    >>> import jax.numpy as jnp
    >>> az, zen = _direction_angles_deg(jnp.array([1.0, 0.0, 0.0]))
    >>> round(float(az)), round(float(zen))
    (0, 90)
    >>> az, zen = _direction_angles_deg(jnp.array([0.0, 0.0, 1.0]))
    >>> round(float(zen))  # +z is the pole
    0
    """
    _, elevation, azimuth = jnp.moveaxis(cartesian_to_spherical(k), -1, 0)
    return jnp.rad2deg(azimuth), jnp.rad2deg(elevation)


def export(
    *,
    paths: TracedPaths | Iterable[TracedPaths],
    scene: Scene,
    radio_materials: Mapping[str, Material] | None = None,
    frequency: Float[ArrayLike, ""],
    include_primitives: bool = False,
    polarization: (
        Literal["V", "H"]
        | Float[ArrayLike, "3"]
        | tuple[Any, Any]
    ) = "V",
) -> DeepMIMO[Array]:
    """Export traced paths to the DeepMIMO format.

    Assumes far-field propagation in free space and isotropic antennas.
    Feature parity: reference ``deepmimo.export`` (plugins/deepmimo.py:
    408-724), re-built around the first-class
    :func:`differt_tpu.em.transition_matrix` op with scalar theta/phi field
    carriers. Per-order batches are computed independently and merged once
    at the end, so multi-order inputs compile one kernel per order instead
    of a growing concat chain.
    """
    if scene.mesh.face_materials is None:
        msg = (
            "Cannot export paths without per-face material information;"
            " load or assign materials on the scene mesh first."
        )
        raise ValueError(msg)
    if radio_materials is None:
        radio_materials = materials

    if isinstance(polarization, tuple) and len(polarization) == 2:
        tx_pol, rx_pol = polarization
    else:
        tx_pol = rx_pol = polarization

    n_complex, thickness = _slab_tables(
        radio_materials, scene.mesh.material_names, frequency
    )
    wavelength = c / frequency

    tx_pos = scene.transmitters.reshape(-1, 3)
    rx_pos = scene.receivers.reshape(-1, 3)
    num_tx = tx_pos.shape[0]
    num_rx = rx_pos.shape[0]

    def batch_channel(batch: TracedPaths) -> dict[str, Array]:
        """Channel amplitude + geometry for one (single-order) path batch."""
        batch = batch.reshape(num_tx, num_rx, -1)
        k_hat, seg_len = normalize(jnp.diff(batch.vertices, axis=-2), keepdims=True)
        total_len = seg_len.sum(axis=(-2, -1))

        e_theta, e_phi = _transmit_field(tx_pol, k_hat[..., 0, :])
        if batch.order > 0:
            bounce_objects = batch.objects[..., 1:-1]
            slab_ids = jnp.take(scene.mesh.face_materials, bounce_objects, axis=0)
            e_theta, e_phi = transition_apply(
                batch.vertices,
                jnp.take(scene.mesh.normals, bounce_objects, axis=0),
                jnp.take(n_complex, slab_ids, axis=0, mode="clip"),
                jnp.take(thickness, slab_ids, axis=0, mode="clip"),
                wavelength,
                e_theta,
                e_phi,
                interaction_types=batch.interaction_types,
            )
        amplitude = _receive_projection(rx_pol, k_hat[..., -1, :], e_theta, e_phi)

        # Free-space 1/s spreading and e^{-j 2 pi f s / c} propagation phase.
        phase = -2.0 * jnp.pi * frequency * total_len / c
        amplitude = amplitude * safe_divide(1.0, total_len) * jax.lax.complex(
            jnp.cos(phase), jnp.sin(phase)
        )

        types = batch.interaction_types
        if types is None:
            types = jnp.full_like(
                batch.objects[..., 1:-1], InteractionType.REFLECTION
            )
        valid = batch.mask
        if valid is None:
            valid = jnp.ones(batch.shape, dtype=bool)
        return {
            "amplitude": amplitude,
            "length": total_len,
            "k_first": k_hat[..., 0, :],
            "k_last": k_hat[..., -1, :],
            "types": types,
            "points": batch.vertices[..., 1:-1, :],
            "objects": batch.objects[..., 1:-1],
            "valid": valid,
        }

    batches = [paths] if isinstance(paths, TracedPaths) else list(paths)
    if not batches:
        # No path batches: emit a structurally-valid, zero-path dataset.
        empty = TracedPaths(
            vertices=jnp.zeros((num_tx, num_rx, 0, 2, 3)),
            objects=jnp.zeros((num_tx, num_rx, 0, 2), dtype=jnp.int32),
            mask=jnp.zeros((num_tx, num_rx, 0), dtype=bool),
            interaction_types=jnp.zeros((num_tx, num_rx, 0, 0), dtype=jnp.int32),
        )
        batches = [empty]
    per_order = [batch_channel(batch) for batch in batches]

    def flat(field: str) -> Array:
        return jnp.concatenate([p[field] for p in per_order], axis=-1)

    widest = max(p["types"].shape[3] for p in per_order)
    amplitude = flat("amplitude") * (wavelength / (4 * jnp.pi))
    aod_az, aod_el = _direction_angles_deg(
        jnp.concatenate([p["k_first"] for p in per_order], axis=2)
    )
    aoa_az, aoa_el = _direction_angles_deg(
        jnp.concatenate([-p["k_last"] for p in per_order], axis=2)
    )

    return DeepMIMO(
        power=10.0 * jnp.log10(jnp.abs(amplitude) ** 2 / z_0),
        phase=jnp.angle(amplitude, deg=True),
        delay=flat("length") / c,
        aoa_az=aoa_az,
        aoa_el=aoa_el,
        aod_az=aod_az,
        aod_el=aod_el,
        inter=_stack_ragged([p["types"] for p in per_order], -1, widest),
        inter_pos=_stack_ragged([p["points"] for p in per_order], 0.0, widest),
        rx_pos=rx_pos,
        tx_pos=tx_pos,
        mask=flat("valid"),
        primitives=_stack_ragged([p["objects"] for p in per_order], -1, widest)
        if include_primitives
        else None,
    )
