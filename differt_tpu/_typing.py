"""Array type annotations, with or without ``jaxtyping``.

When ``jaxtyping`` is installed its names are re-exported, so shape and
dtype annotations stay checkable at run time (``tests/test_typecheck.py``).
Without it, subscriptable stand-ins take their place: ``Float[Array, "n 3"]``
evaluates to ``Array``, every annotation in the package still evaluates,
and ``import differt_tpu`` needs nothing beyond JAX and NumPy.

Examples:
    >>> from differt_tpu._typing import Array, Float
    >>> Float[Array, "n 3"] is not None
    True
"""

try:
    from jaxtyping import (
        Array,
        ArrayLike,
        Bool,
        Complex,
        DTypeLike,
        Float,
        Inexact,
        Int,
        Num,
        PRNGKeyArray,
        Shaped,
    )
except ImportError:  # pragma: no cover - exercised in a subprocess test.
    import jax

    Array = jax.Array
    ArrayLike = jax.typing.ArrayLike
    DTypeLike = jax.typing.DTypeLike
    PRNGKeyArray = jax.Array

    class _DtypeAnnotation:
        """``Kind[array_type, "shape"]`` evaluates to ``array_type``."""

        def __class_getitem__(cls, item):
            return item[0] if isinstance(item, tuple) else item

    Bool = Complex = Float = Inexact = Int = Num = Shaped = _DtypeAnnotation


__all__ = [
    "Array",
    "ArrayLike",
    "Bool",
    "Complex",
    "DTypeLike",
    "Float",
    "Inexact",
    "Int",
    "Num",
    "PRNGKeyArray",
    "Shaped",
]
