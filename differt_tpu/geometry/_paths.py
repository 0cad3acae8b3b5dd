"""Path containers: :class:`TracedPaths` and :class:`LaunchedPaths`.

Feature parity target: ``differt.geometry.TracedPaths`` / ``LaunchedPaths``
(reference differt/src/differt/geometry/_paths.py). Paths are stored with
full, fixed batch shapes plus a validity mask (boolean or float confidence),
the JIT- and sharding-stable representation: invalid paths are masked, never
dropped, so every chip holds identical shapes.

Implementation notes (device-first, not a port):

- Batch-shape surgery (``reshape`` / ``squeeze`` / ``masked``) is driven by a
  single per-class table of *trailing* (non-batch) ranks and one generic
  :func:`_remap_batch` helper, so every field stays in lock-step by
  construction.
- Row-grouping (:func:`merge_cell_ids`, :meth:`TracedPaths.group_by_objects`,
  :meth:`TracedPaths.multipath_cells`, duplicate masking) is built on
  :func:`_group_index`, a tiled first-occurrence search: each tile of query
  rows is compared against the whole row set with one dense vectorized
  equality + ``argmax``. This keeps the device busy with wide elementwise
  compares instead of a sequential scan, while ``lax.map`` over tiles bounds
  the working set.
"""

from collections.abc import Callable, Iterator, Sequence
from typing import Any

import jax
import jax.numpy as jnp
from .._typing import Array, ArrayLike, Bool, Float, Int, Num, Shaped

from differt_tpu import treekit as eqx

# Queries per tile in _group_index: bounds the [tile, num_rows, n] equality
# buffer while keeping each compare wide enough to fill the device.
_GROUP_TILE = 128


def _group_index(rows: Shaped[Array, "num_rows n"]) -> Int[Array, " num_rows"]:
    """Give each row the index of the first row equal to it.

    Rows that are equal share an output value (the position of their first
    occurrence), so the result doubles as a group id. Runs in tiles of
    :data:`_GROUP_TILE` query rows so memory stays bounded at
    ``O(tile * num_rows)`` regardless of batch size.
    """
    num_rows = rows.shape[0]
    if num_rows == 0:
        return jnp.zeros((0,), dtype=jnp.int32)
    tile = min(num_rows, _GROUP_TILE)
    num_tiles = -(-num_rows // tile)
    padded = num_tiles * tile
    queries = jnp.pad(rows, ((0, padded - num_rows), (0, 0))).reshape(
        num_tiles, tile, rows.shape[1]
    )

    def first_match(tile_rows: Shaped[Array, "tile n"]) -> Int[Array, " tile"]:
        hits = (tile_rows[:, None, :] == rows[None, :, :]).all(axis=-1)
        return jnp.argmax(hits, axis=-1).astype(jnp.int32)

    return jax.lax.map(first_match, queries).reshape(padded)[:num_rows]


@jax.jit
def merge_cell_ids(
    cell_ids_a: Int[ArrayLike, " *batch"],
    cell_ids_b: Int[ArrayLike, " *batch"],
) -> Int[Array, " *batch"]:
    """Combine two cell-id arrays into one: ids match iff both inputs match.

    The output values are fresh group ids with no relation to either input's
    numbering. Inputs are broadcast against each other.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import merge_cell_ids
        >>> merge_cell_ids(
        ...     jnp.array([0, 0, 1, 1]), jnp.array([0, 1, 0, 0])
        ... ).tolist()
        [0, 1, 2, 2]
    """
    pairs = jnp.stack(
        jnp.broadcast_arrays(jnp.asarray(cell_ids_a), jnp.asarray(cell_ids_b)),
        axis=-1,
    )
    return _group_index(pairs.reshape(-1, 2)).reshape(pairs.shape[:-1])


def _remap_batch(paths, fn: Callable[[Array, int], Array]):
    """Apply ``fn(array, trailing_ndim)`` to every batch-shaped field.

    ``trailing_ndim`` counts the fixed per-path dimensions after the batch
    (e.g. 2 for ``vertices``' ``[path_length, 3]`` tail), letting ``fn``
    locate the batch part of each array.
    """
    names = tuple(name for name, _ in paths._BATCH_AXES)
    updated = tuple(
        fn(getattr(paths, name), trailing) for name, trailing in paths._BATCH_AXES
    )
    return eqx.tree_at(
        lambda p: tuple(getattr(p, name) for name in names), paths, updated
    )


def _squeeze_axes(
    axis: int | Sequence[int] | None, batch_shape: tuple[int, ...]
) -> tuple[int, ...]:
    """Validate and normalize squeeze axes relative to the batch shape."""
    ndim = len(batch_shape)
    if axis is None:
        if ndim == 0:
            msg = "A 0-dimensional batch has no axes left to squeeze."
            raise ValueError(msg)
        # Squeeze only *batch* axes of extent one; trailing per-path
        # dimensions are never touched (unlike a bare jnp.squeeze()).
        return tuple(i for i, extent in enumerate(batch_shape) if extent == 1)
    requested = (axis,) if isinstance(axis, int) else tuple(axis)
    resolved = []
    for a in requested:
        shifted = a + ndim if a < 0 else a
        if shifted < 0 or shifted >= ndim:
            msg = f"Squeeze axis {a} is out-of-bounds for a {ndim}-dimensional batch."
            raise ValueError(msg)
        resolved.append(shifted)
    return tuple(resolved)


def _confident(
    mask: Bool[Array, " *batch"] | Float[Array, " *batch"],
    threshold: Float[ArrayLike, ""],
) -> Bool[Array, " *batch"]:
    """Resolve a boolean-or-confidence mask into a boolean one."""
    if jnp.issubdtype(mask.dtype, jnp.bool_):
        return mask
    return mask >= threshold


class TracedPaths(eqx.Module):
    """Paths produced by exact tracing (image method / Fermat solvers).

    Feature parity: reference ``TracedPaths`` (_paths.py:77-492).
    """

    vertices: Float[Array, "*batch path_length 3"]
    """Path vertex coordinates."""
    objects: Int[Array, "*batch path_length"]
    """Object index per vertex (-1 for TX/RX placeholders)."""
    mask: Bool[Array, " *batch"] | Float[Array, " *batch"]
    """Validity mask, or float confidence compared to :attr:`confidence_threshold`."""
    interaction_types: Int[Array, "*batch path_length-2"]
    """Per-bounce :class:`InteractionType<differt_tpu.em.InteractionType>` values (-1 = padded)."""
    confidence_threshold: Float[ArrayLike, ""] = 0.5
    """Threshold above which a float confidence counts as valid."""

    # (field, trailing non-batch rank) — drives _remap_batch.
    _BATCH_AXES = (
        ("vertices", 2),
        ("objects", 1),
        ("mask", 0),
        ("interaction_types", 1),
    )

    @property
    def shape(self) -> tuple[int, ...]:
        """Batch shape."""
        return self.vertices.shape[:-2]

    @property
    def path_length(self) -> int:
        """Number of vertices per path."""
        return self.objects.shape[-1]

    @property
    def order(self) -> int:
        """Number of interactions per path."""
        return self.path_length - 2

    @property
    def valid_mask(self) -> Bool[Array, " *batch"]:
        """Boolean validity mask (confidence masks resolved via the threshold)."""
        return _confident(self.mask, self.confidence_threshold)

    @property
    def num_valid_paths(self) -> Int[Array, ""]:
        """Traceable count of valid paths."""
        return jnp.count_nonzero(self.valid_mask)

    def reshape(self, *batch: int) -> "TracedPaths":
        """Reshape batch dimensions (``-1`` wildcards allowed)."""
        probe = self.vertices.reshape(*batch, self.path_length, 3)
        target = probe.shape[:-2]
        return _remap_batch(
            self, lambda arr, nd: arr.reshape(*target, *arr.shape[arr.ndim - nd :])
        )

    def squeeze(self, axis: int | Sequence[int] | None = None) -> "TracedPaths":
        """Drop unit-extent batch dimensions.

        Raises:
            ValueError: If an axis is out-of-bounds for the batch shape, or
                if the batch is already 0-dimensional.
        """
        axes = _squeeze_axes(axis, self.shape)
        return _remap_batch(self, lambda arr, nd: jnp.squeeze(arr, axis=axes))

    @eqx.filter_jit
    def mask_duplicate_objects(self, axis: int = -1) -> "TracedPaths":
        """Mask paths whose object sequence repeats an earlier one along ``axis``.

        Only the first occurrence of each object sequence stays valid; the
        batch shape is unchanged, so the result is JIT- and sharding-stable.
        Useful when an upstream candidate generator (e.g. a sampling model)
        may emit the same candidate twice.

        Raises:
            ValueError: If ``axis`` is out-of-bounds for the batch shape.
        """
        ndim = self.objects.ndim - 1
        resolved = axis + ndim if axis < 0 else axis
        if resolved < 0 or resolved >= ndim:
            msg = f"Axis {axis} is out-of-bounds for a {ndim}-dimensional batch."
            raise ValueError(msg)

        # Bring the candidate axis next to the per-path axis, flatten every
        # other batch dimension, and mark first occurrences per group.
        sequences = jnp.moveaxis(self.objects, resolved, -2)
        *lead, axis_len, path_len = sequences.shape
        positions = jnp.arange(axis_len, dtype=jnp.int32)

        def firsts(rows: Int[Array, "axis_len path_len"]) -> Bool[Array, " axis_len"]:
            return _group_index(rows) == positions

        keep = jax.vmap(firsts)(sequences.reshape(-1, axis_len, path_len))
        keep = jnp.moveaxis(keep.reshape(*lead, axis_len), -1, resolved)
        return eqx.tree_at(lambda p: p.mask, self, self.mask * keep)

    def masked(self) -> "TracedPaths":
        """Flatten the batch and keep valid paths only (not jittable)."""
        flat = self.reshape(-1)
        picks = jnp.where(flat.valid_mask)[0]
        gathered = _remap_batch(flat, lambda arr, nd: jnp.take(arr, picks, axis=0))
        return eqx.tree_at(
            lambda p: p.mask, gathered, jnp.ones(picks.shape, dtype=jnp.bool_)
        )

    @property
    def masked_vertices(self) -> Float[Array, "num_valid_paths path_length 3"]:
        """Flattened vertices of valid paths only (not jittable)."""
        return self.masked().vertices

    @property
    def masked_objects(self) -> Int[Array, "num_valid_paths path_length"]:
        """Flattened objects of valid paths only (not jittable)."""
        return self.masked().objects

    @eqx.filter_jit
    def multipath_cells(self, axis: int = -1) -> Int[Array, " *partial_batch"]:
        """Group batch entries sharing an identical validity pattern along ``axis``.

        Entries with the same set of valid candidates receive the same cell
        id — the multipath-cell structure behind multipath lifetime maps.
        """
        patterns = jnp.moveaxis(self.valid_mask, axis, -1)
        *partial_batch, width = patterns.shape
        return _group_index(patterns.reshape(-1, width)).reshape(partial_batch)

    @jax.jit
    def group_by_objects(self) -> Int[Array, " *batch"]:
        """Group paths undergoing the same object interactions.

        Examples:
            >>> import jax.numpy as jnp
            >>> from differt_tpu.geometry import TracedPaths
            >>> objects = jnp.array([[0, 1, 0], [0, 2, 0], [0, 1, 0]])
            >>> paths = TracedPaths(
            ...     vertices=jnp.zeros((3, 3, 3)),
            ...     objects=objects,
            ...     mask=jnp.ones(3, dtype=bool),
            ...     interaction_types=jnp.zeros((3, 1), dtype=jnp.int32),
            ... )
            >>> paths.group_by_objects().tolist()
            [0, 1, 0]
        """
        *batch, path_length = self.objects.shape
        return _group_index(self.objects.reshape(-1, path_length)).reshape(batch)

    def reduce(
        self,
        fun: Callable[[Num[Array, "*batch path_length 3"]], Num[Array, " *batch"]],
        axis: int | Sequence[int] | None = None,
    ) -> Num[Array, "..."]:
        """Masked sum of ``fun(vertices)`` over (some) batch axes.

        With a float confidence mask, contributions are weighted by the
        confidence, keeping the result differentiable through the mask.
        """
        contributions = fun(self.vertices)
        if jnp.issubdtype(self.mask.dtype, jnp.bool_):
            # jnp.where (not multiply-by-0) so invalid NaN/inf paths drop out.
            contributions = jnp.where(self.mask, contributions, 0)
        else:
            contributions = contributions * self.mask
        return jnp.sum(contributions, axis=axis)

    def pad_order(self, target_order: int) -> "TracedPaths":
        """Pad every path to ``target_order`` interactions.

        The extra interaction points are placed collinearly ALONG the final
        segment (between the last real interaction and the RX vertex), so no
        segment degenerates to zero length: total path length, delay, and
        every departure/arrival/reflection frame are unchanged. Padded slots
        carry object index -1 and interaction type -1, which the EM pipeline
        treats as pass-through no-ops. This is the ragged-to-static bridge
        that lets multi-order traces share one container on device.

        Raises:
            ValueError: If ``target_order`` is below the current order.
        """
        extra = target_order - self.order
        if extra < 0:
            msg = (
                f"Cannot pad order-{self.order} paths down to order "
                f"{target_order}."
            )
            raise ValueError(msg)
        if extra == 0:
            return self
        v = self.vertices
        seg_start = v[..., -2:-1, :]
        seg_end = v[..., -1:, :]
        fractions = (
            jnp.arange(1, extra + 1, dtype=v.dtype) / (extra + 1)
        ).reshape(*([1] * (v.ndim - 2)), extra, 1)
        interior = seg_start + (seg_end - seg_start) * fractions
        vertices = jnp.concatenate((v[..., :-1, :], interior, seg_end), axis=-2)
        obj_pad = jnp.full(
            (*self.objects.shape[:-1], extra), -1, self.objects.dtype
        )
        objects = jnp.concatenate(
            (self.objects[..., :-1], obj_pad, self.objects[..., -1:]), axis=-1
        )
        it_pad = jnp.full(
            (*self.interaction_types.shape[:-1], extra),
            -1,
            self.interaction_types.dtype,
        )
        interaction_types = jnp.concatenate(
            (self.interaction_types, it_pad), axis=-1
        )
        return eqx.tree_at(
            lambda p: (p.vertices, p.objects, p.interaction_types),
            self,
            (vertices, objects, interaction_types),
        )

    def __iter__(self) -> Iterator["TracedPaths"]:
        """Iterate over individually-masked valid paths."""
        flat = self.masked()
        scalar_true = jnp.ones((), dtype=jnp.bool_)
        for i in range(flat.vertices.shape[0]):
            yield TracedPaths(
                vertices=flat.vertices[i],
                objects=flat.objects[i],
                mask=scalar_true,
                interaction_types=flat.interaction_types[i],
                confidence_threshold=flat.confidence_threshold,
            )

    def plot(self, **kwargs: Any):
        """Plot the valid paths. See :func:`differt_tpu.plotting.draw_paths`."""
        from ..plotting import draw_paths

        return draw_paths(self.masked_vertices, **kwargs)


def concatenate_paths(batches: Sequence[TracedPaths]) -> TracedPaths:
    """Join path batches along the candidate (last batch) axis.

    Batches of different orders are first padded to the highest order via
    :meth:`TracedPaths.pad_order`, so e.g. a multi-order trace merges into
    ONE static-shape container — the static-shape answer to the reference's
    one-``TracedPaths``-per-order iterator (its solvers raise on multi-order
    input, reference _scene.py:704-708). All other batch axes must agree.

    Examples:
        >>> import jax.numpy as jnp
        >>> from differt_tpu.geometry import TracedPaths, concatenate_paths
        >>> def batch(order, n):
        ...     return TracedPaths(
        ...         vertices=jnp.zeros((n, order + 2, 3)),
        ...         objects=jnp.zeros((n, order + 2), dtype=jnp.int32),
        ...         mask=jnp.ones(n, dtype=bool),
        ...         interaction_types=jnp.zeros((n, order), dtype=jnp.int32),
        ...     )
        >>> merged = concatenate_paths([batch(1, 4), batch(2, 6)])
        >>> merged.shape, merged.order
        ((10,), 2)
    """
    if not batches:
        msg = "concatenate_paths needs at least one batch."
        raise ValueError(msg)
    target = max(b.order for b in batches)
    padded = [b.pad_order(target) for b in batches]
    first = padded[0]

    def cat(name: str, trailing: int) -> Array:
        arrays = [getattr(b, name) for b in padded]
        return jnp.concatenate(arrays, axis=arrays[0].ndim - trailing - 1)

    names = tuple(name for name, _ in TracedPaths._BATCH_AXES)
    return eqx.tree_at(
        lambda p: tuple(getattr(p, n) for n in names),
        first,
        tuple(cat(n, t) for n, t in TracedPaths._BATCH_AXES),
    )


class Paths(TracedPaths):
    """Deprecated alias for :class:`TracedPaths` (reference parity: _paths.py:496-510)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        import warnings

        warnings.warn(
            "Paths was renamed to TracedPaths; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)


class LaunchedPaths(eqx.Module):
    """Paths produced by ray launching (SBR), with per-order masks.

    Feature parity: reference ``LaunchedPaths`` (_paths.py:513-714).
    """

    vertices: Float[Array, "*batch path_length 3"]
    """Path vertex coordinates."""
    objects: Int[Array, "*batch path_length"]
    """Object index per vertex."""
    masks: Bool[Array, "*batch path_length-1"]
    """One validity mask per path order."""
    interaction_types: Int[Array, "*batch path_length-2"]
    """Per-bounce interaction types."""
    confidence_threshold: Float[ArrayLike, ""] = 0.5
    """Confidence threshold (kept for symmetry with :class:`TracedPaths`)."""

    _BATCH_AXES = (
        ("vertices", 2),
        ("objects", 1),
        ("masks", 1),
        ("interaction_types", 1),
    )

    @property
    def shape(self) -> tuple[int, ...]:
        """Batch shape."""
        return self.vertices.shape[:-2]

    @property
    def path_length(self) -> int:
        """Number of vertices per path."""
        return self.objects.shape[-1]

    @property
    def order(self) -> int:
        """Number of interactions per path."""
        return self.path_length - 2

    @property
    def mask(self) -> Bool[Array, " *batch"]:
        """Alias for the highest-order mask."""
        return self.masks[..., -1]

    def get_paths(self, order: int) -> TracedPaths:
        """Extract the :class:`TracedPaths` of a given order.

        Raises:
            ValueError: If ``order`` exceeds the launched maximum.
        """
        if not 0 <= order <= self.order:
            msg = (
                f"The requested order must be between 0 and {self.order} "
                f"(inclusive), got {order}."
            )
            raise ValueError(msg)
        # An order-k path uses the launch point, the first k interactions,
        # and the capture point stored in the final slot.
        head = slice(None, order + 1)
        return TracedPaths(
            vertices=jnp.concatenate(
                (self.vertices[..., head, :], self.vertices[..., -1:, :]), axis=-2
            ),
            objects=jnp.concatenate(
                (self.objects[..., head], self.objects[..., -1:]), axis=-1
            ),
            mask=self.masks[..., order],
            interaction_types=self.interaction_types[..., :order],
            confidence_threshold=self.confidence_threshold,
        )

    def reshape(self, *batch: int) -> "LaunchedPaths":
        """Reshape batch dimensions (``-1`` wildcards allowed)."""
        probe = self.vertices.reshape(*batch, self.path_length, 3)
        target = probe.shape[:-2]
        return _remap_batch(
            self, lambda arr, nd: arr.reshape(*target, *arr.shape[arr.ndim - nd :])
        )

    def squeeze(self, axis: int | Sequence[int] | None = None) -> "LaunchedPaths":
        """Drop unit-extent batch dimensions."""
        axes = _squeeze_axes(axis, self.shape)
        return _remap_batch(self, lambda arr, nd: jnp.squeeze(arr, axis=axes))

    def masked(self) -> TracedPaths:
        """Flattened highest-order valid paths."""
        return self.get_paths(self.order).masked()

    @property
    def masked_vertices(self) -> Float[Array, "num_valid_paths path_length 3"]:
        """Flattened vertices of valid highest-order paths."""
        return self.masked().vertices

    @property
    def masked_objects(self) -> Int[Array, "num_valid_paths path_length"]:
        """Flattened objects of valid highest-order paths."""
        return self.masked().objects

    def __iter__(self) -> Iterator[TracedPaths]:
        """Iterate over highest-order masked paths."""
        yield from self.get_paths(self.order)

    def plot(self, **kwargs: Any):
        """Plot paths of every order."""
        from ..plotting import reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            for order in range(self.order + 1):
                self.get_paths(order).plot()
        return output


class SBRPaths(LaunchedPaths):
    """Deprecated alias for :class:`LaunchedPaths` (reference parity: _paths.py:718-732)."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        import warnings

        warnings.warn(
            "SBRPaths was renamed to LaunchedPaths; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
