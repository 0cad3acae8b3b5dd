"""Materials and the ITU-R P.2040-4 material table.

Reference parity: differt/src/differt/em/_material.py. Electrical properties
follow the ITU-R P.2040-4 model: relative permittivity ``a * f_GHz**b`` and
conductivity ``c * f_GHz**d`` per frequency range (out-of-range -> -1).
Frequency-range selection is vectorized with ``jnp.where`` chains (static
range bounds), which XLA folds into a handful of selects — no host control
flow, so material lookups stay inside jit/grad.
"""

import typing
from collections.abc import Callable, Iterable, Mapping
from typing import TYPE_CHECKING, Any

from differt_tpu import treekit as eqx
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Float

if TYPE_CHECKING or hasattr(typing, "GENERATING_DOCS"):
    from typing import Self
else:
    Self = Any

# (a, b, c, d, (f_min_GHz, f_max_GHz) | None)
ItuProperties = tuple[Any, Any, Any, Any, "tuple[Any, Any] | None"]


class Material(eqx.Module):
    """A material with frequency-dependent electrical properties.

    Examples:
        The built-in ITU-R P.2040-4 registry resolves names and aliases:

        >>> from differt_tpu.em import materials
        >>> round(float(materials["itu_concrete"].relative_permittivity(3e9)), 2)
        5.24
        >>> materials["itu_concrete"].name  # the itu_* alias resolves
        'Concrete'
    """

    name: str = eqx.field(static=True)
    """Material name."""
    properties: Callable[
        [Float[ArrayLike, " *batch"]],
        tuple[Float[Array, " *batch"], Float[Array, " *batch"]],
    ] = eqx.field(static=True)
    """Callable ``frequency -> (relative_permittivity, conductivity)``."""
    thickness: Float[ArrayLike, ""] | None = eqx.field(default=None)
    """Optional slab thickness (m); ``None`` = semi-infinite."""
    aliases: tuple[str, ...] = eqx.field(default=(), static=True)
    """Alternative names (e.g., Sionna-style ``itu_*``)."""

    def __repr__(self) -> str:
        extra = "" if self.thickness is None else f", thickness={self.thickness!r}"
        extra += f", aliases={self.aliases!r}" if self.aliases else ""
        return f"Material(name={self.name!r}{extra})"

    def relative_permittivity(
        self, frequency: Float[ArrayLike, " *batch"]
    ) -> Float[Array, " *batch"]:
        """Relative permittivity at the given frequency (Hz)."""
        return self.properties(frequency)[0]

    def conductivity(
        self, frequency: Float[ArrayLike, " *batch"]
    ) -> Float[Array, " *batch"]:
        """Conductivity (S/m) at the given frequency (Hz)."""
        return self.properties(frequency)[1]

    @classmethod
    def from_itu_properties(cls, name: str, *itu_properties: ItuProperties) -> Self:
        """Build a material from ITU-R P.2040-4 ``(a, b, c, d, f_range_GHz)`` rows.

        With several ranges, the first (sorted by lower bound) matching range
        wins; out of all ranges both properties are -1.
        """
        if len(itu_properties) > 1 and any(p[4] is None for p in itu_properties):
            msg = (
                "A catch-all range (frequency bounds of 'None') cannot be"
                " combined with other ranges: it would shadow them."
            )
            raise ValueError(msg)

        aliases = (f"itu_{name.lower().replace(' ', '_')}",)

        ranges_hz = [
            (p[4][0] * 1e9, p[4][1] * 1e9) if p[4] is not None else (-jnp.inf, jnp.inf)
            for p in itu_properties
        ]
        order = sorted(range(len(ranges_hz)), key=lambda i: ranges_hz[i])
        rows = [
            (
                itu_properties[i][0],
                itu_properties[i][1],
                itu_properties[i][2],
                itu_properties[i][3],
                ranges_hz[i],
            )
            for i in order
        ]

        def properties(
            frequency: Float[ArrayLike, " *batch"],
        ) -> tuple[Float[Array, " *batch"], Float[Array, " *batch"]]:
            f_hz = jnp.asarray(frequency)
            f_ghz = f_hz * 1e-9
            rel_perm = jnp.full_like(f_ghz, -1.0)
            cond = jnp.full_like(f_ghz, -1.0)
            # Later (higher-range) rows must not override earlier matches:
            # iterate in reverse so the first (lowest) matching range wins.
            for a, b, c, d, (lo, hi) in reversed(rows):
                in_range = (f_hz >= lo) & (f_hz <= hi)
                rel_perm = jnp.where(in_range, a * (f_ghz**b), rel_perm)
                cond = jnp.where(in_range, c * (f_ghz**d), cond)
            return rel_perm, cond

        return cls(name=name, properties=properties, aliases=aliases)


class MaterialsDict(dict):
    """Dict of materials with automatic alias resolution.

    Reference parity: _material.py:233-304.
    """

    def __init__(
        self,
        other: Mapping[str, Material] | Iterable[Material | tuple[str, Material]] = (),
        /,
        **kwargs: Material,
    ) -> None:
        super().__init__()
        self.update(other, **kwargs)

    def _resolve(self, key: Any) -> Any:
        if not isinstance(key, str) or super().__contains__(key):
            return key
        return next(
            (name for name, mat in self.items() if key in mat.aliases), key
        )

    def __missing__(self, key: str) -> Material:
        real = self._resolve(key)
        if real == key:
            raise KeyError(key)
        return self[real]

    def __contains__(self, key: object) -> bool:
        return super().__contains__(self._resolve(key))

    def __delitem__(self, key: str) -> None:
        super().__delitem__(self._resolve(key))

    def __setitem__(self, key: str, value: Material) -> None:
        real = self._resolve(key)
        if super().__contains__(real):
            super().__setitem__(real, value)
        elif isinstance(value, Material):
            super().__setitem__(value.name, value)
        else:
            super().__setitem__(key, value)

    def get(self, key: object, default: Any = None) -> Any:
        return super().get(self._resolve(key), default)

    def pop(self, key: object, *default: Any) -> Any:
        real = self._resolve(key)
        if super().__contains__(real):
            return super().pop(real)
        if default:
            return default[0]
        raise KeyError(key)

    def setdefault(self, key: str, default: Any = None) -> Any:
        real = self._resolve(key)
        if super().__contains__(real):
            return self[real]
        self[key] = default
        return default

    def update(self, other: Any = (), /, **kwargs: Material) -> None:
        items: Iterable[Any] = other.items() if isinstance(other, Mapping) else other
        for item in items:
            if isinstance(item, Material):
                self[item.name] = item
            else:
                key, value = item
                self[key] = value
        for key, value in kwargs.items():
            self[key] = value


# ITU-R P.2040-4 Table 3 coefficients (public standard data).
_ITU_MATERIALS_TABLE: dict[str, tuple[ItuProperties, ...]] = {
    "Vacuum": ((1.0, 0.0, 0.0, 0.0, None),),
    "Concrete": (
        (5.24, 0.0, 0.0462, 0.7822, (1.0, 100.0)),
        (5.17, 0.0, 0.0145, 1.09, (110.0, 330.0)),
    ),
    "Brick": (
        (3.91, 0.0, 0.0238, 0.16, (1.0, 40.0)),
        (3.75, 0.0, 0.038, 0.0, (1.0, 10.0)),
        (3.95, 0.0, 0.0022, 1.33, (100.0, 400.0)),
    ),
    "Plasterboard": (
        (2.94, 0.0, 0.0116, 0.7076, (1.0, 100.0)),
        (2.73, 0.0, 0.0084, 0.94, (100.0, 400.0)),
    ),
    "Wood": (
        (1.99, 0.0, 0.0047, 1.0718, (0.001, 100.0)),
        (1.63, 0.0, 0.0076, 1.002, (100.0, 400.0)),
    ),
    "Glass": (
        (6.27, 0.0, 0.0043, 1.1925, (0.1, 100.0)),
        (6.70, 0.0, 0.0042, 1.15, (100.0, 400.0)),
        (6.01, 0.0, 0.0400, 0.81, (220.0, 450.0)),
    ),
    "Clear Acrylic": ((2.57, 0.0, 0.0049, 1.0601, (1.0, 40.0)),),
    "Ceiling board": (
        (1.48, 0.0, 0.0011, 1.1278, (1.0, 100.0)),
        (1.58, 0.0, 0.0014, 1.07, (100.0, 400.0)),
    ),
    "Chipboard": (
        (2.58, 0.0, 0.0217, 0.7800, (1.0, 100.0)),
        (2.16, 0.0, 0.0023, 1.359, (100.0, 200.0)),
    ),
    "Plywood": (
        (2.71, 0.0, 0.33, 0.0, (1.0, 40.0)),
        (1.94, 0.0, 0.0067, 0.9982, (110.0, 330.0)),
        (2.17, 0.0, 0.0063, 1.045, (100.0, 400.0)),
    ),
    "Marble": (
        (7.074, 0.0, 0.0055, 0.9262, (1.0, 60.0)),
        (7.94, 0.0, 0.0001, 1.7330, (110.0, 330.0)),
        (8.62, 0.0, 0.0027, 1.15, (100.0, 400.0)),
    ),
    "Floorboard": (
        (3.66, 0.0, 0.0044, 1.3515, (50.0, 100.0)),
        (5.27, 0.0, 2.22e-17, 7.3413, (220.0, 300.0)),
        (5.27, 0.0, 0.0003, 2.0298, (300.0, 400.0)),
        (5.27, 0.0, 49.8726, 0.0, (400.0, 450.0)),
        (3.1575, 0.0, 0.001675, 1.32775, (100.0, 400.0)),
    ),
    "Vinyl tile": ((3.62, 0.0, 0.0051, 0.8422, (1.0, 40.0)),),
    "Carpet tile": ((2.08, 0.0, 0.0009, 0.8200, (1.0, 40.0)),),
    "Asphalt concrete": ((4.83, 0.0, 0.0108, 1.3969, (1.0, 40.0)),),
    "Metal": ((1.0, 0.0, 1e7, 0.0, (1.0, 100.0)),),
    "Very dry ground": ((3.0, 0.0, 0.00015, 2.52, (1.0, 10.0)),),
    "Medium dry ground": ((15.0, -0.1, 0.035, 1.63, (1.0, 10.0)),),
    "Wet ground": ((30.0, -0.4, 0.15, 1.30, (1.0, 10.0)),),
}

materials: MaterialsDict = MaterialsDict(
    Material.from_itu_properties(name, *props)
    for name, props in _ITU_MATERIALS_TABLE.items()
)
"""Built-in ITU radio materials, accessible by name or ``itu_*`` alias."""
