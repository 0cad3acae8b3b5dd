"""Sharding helpers and sharded end-to-end ops."""

from collections.abc import Sequence
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from .. import treekit as tk
from .._typing import Array, ArrayLike, Float
from ..coverage import received_power
from ..geometry import Scene, TracedPaths, generate_path_candidates
from ..rt._solvers import trace_path_candidates as _trace_path_candidates


def make_device_mesh(
    num_devices: int | None = None,
    axis_name: str = "rx",
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """A 1-D device mesh over the first ``num_devices`` devices.

    Examples:
        >>> from differt_tpu.parallel import make_device_mesh
        >>> mesh = make_device_mesh(1)
        >>> mesh.axis_names
        ('rx',)
        >>> mesh.devices.size
        1
    """
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), axis_names=(axis_name,))


def shard_along(x: ArrayLike, mesh: Mesh, axis: int = 0) -> Array:
    """Place ``x`` sharded along ``axis`` over the mesh's (single) axis."""
    axis_name = mesh.axis_names[0]
    spec = [None] * jnp.ndim(x)
    spec[axis] = axis_name
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate every array leaf of a pytree across the mesh."""
    sharding = NamedSharding(mesh, P())

    def put(x: Any) -> Any:
        if isinstance(x, (jax.Array, np.ndarray)):
            return jax.device_put(jnp.asarray(x), sharding)
        return x

    return jax.tree_util.tree_map(put, tree)


def sharded_trace_paths(
    scene: Scene,
    order: int,
    mesh: Mesh,
    *,
    shard_candidates: bool = True,
    **solver_kwargs: Any,
) -> TracedPaths:
    """Exhaustive trace with the candidate axis sharded across chips.

    Because candidates are decoded from a closed-form index mapping, each
    chip could decode its own index range locally; with ``jax.sharding``
    the same effect falls out of sharding the candidate array and letting
    XLA partition the (embarrassingly parallel) trace. Geometry and TX/RX
    are replicated.
    """
    num_primitives = scene.mesh.num_primitives
    candidates = generate_path_candidates(num_primitives, order)
    if scene.mesh.assume_quads:
        candidates = 2 * candidates

    n = mesh.devices.size
    num_candidates = candidates.shape[0]
    pad = (-num_candidates) % n
    if pad and shard_candidates:
        # Pad with repeats of candidate 0; padded rows are masked out below.
        candidates = jnp.concatenate(
            (candidates, jnp.broadcast_to(candidates[:1], (pad, order))), axis=0
        )
    if shard_candidates:
        candidates = shard_along(candidates, mesh, axis=0)

    scene = replicate(scene, mesh)

    paths = _trace_path_candidates(
        scene.mesh,
        scene.transmitters.reshape(-1, 3),
        scene.receivers.reshape(-1, 3),
        candidates,
        **solver_kwargs,
    )
    if pad and shard_candidates:
        # Mask out the padded duplicates (shape stays sharding-friendly).
        valid = jnp.arange(candidates.shape[0]) < num_candidates
        import differt_tpu.treekit as tk

        paths = tk.tree_at(lambda p: p.mask, paths, paths.mask & valid)
    return paths


@tk.filter_jit
def _sharded_power(
    scene, rx_flat, eta_r, conductivity, thickness, frequency, mesh, order, coherent
):
    """``[num_tx, num_rx_padded]`` power with the RX axis split over ``mesh``.

    Each device traces its own RX shard against the whole scene, which the
    per-device function closes over (replicated). shard_map makes that
    split explicit, so the Pallas ray-cast kernels, which XLA cannot
    partition, run on per-device shapes instead of being replicated.
    """

    def local(rx):
        s = tk.tree_at(lambda sc: sc.receivers, scene, rx)
        paths = s.trace_paths(order=order)
        power = received_power(
            paths,
            s,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            thickness=thickness,
            coherent=coherent,
        )
        return power.reshape(-1, rx.shape[0])

    axis = mesh.axis_names[0]
    # The kernels' outputs carry no varying-axes annotation, so the check
    # is off; every value but the RX shard is replicated.
    return jax.shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=P(None, axis), check_vma=False
    )(rx_flat)


def sharded_power_map(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    mesh: Mesh,
    *,
    order: int = 1,
    eta_r: Float[ArrayLike, " num_materials"] | None = None,
    conductivity: Float[ArrayLike, " num_materials"] | None = None,
    thickness: Float[ArrayLike, " num_materials"] | None = None,
    coherent: bool = True,
) -> Float[Array, "..."]:
    """Coverage map with the RX axis sharded across chips.

    Receivers are flattened, padded to a multiple of the mesh size, and
    sharded; the whole trace + EM pipeline runs SPMD with geometry
    replicated; the output map keeps the RX sharding.
    """
    from ..em import materials as itu_materials

    # Traced (not a static Python float), matching the coverage entry
    # points: frequency sweeps re-use one compiled program and the
    # sharded/unsharded paths round identically.
    frequency = jnp.asarray(frequency)
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

    rx_batch = scene.receivers.shape[:-1]
    rx_flat = scene.receivers.reshape(-1, 3)
    num_rx = rx_flat.shape[0]
    n = mesh.devices.size
    pad = (-num_rx) % n
    if pad:
        rx_flat = jnp.concatenate(
            (rx_flat, jnp.broadcast_to(rx_flat[:1], (pad, 3))), axis=0
        )
    rx_flat = shard_along(rx_flat, mesh, axis=0)

    tx_batch = scene.transmitters.shape[:-1]
    power = _sharded_power(
        scene,
        rx_flat,
        jnp.asarray(eta_r),
        jnp.asarray(conductivity),
        None if thickness is None else jnp.asarray(thickness),
        frequency,
        mesh,
        order,
        coherent,
    )
    power = power[..., :num_rx]
    return power.reshape(*tx_batch, *rx_batch)


def training_step(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    mesh: Mesh,
    *,
    order: int,
    eta_r: Float[Array, " num_materials"],
    conductivity: Float[Array, " num_materials"],
    target_power: Float[Array, "..."],
    learning_rate: float = 1e-2,
) -> tuple[Float[Array, " num_materials"], Float[Array, ""]]:
    """One SPMD gradient-descent step on material permittivity.

    The RX axis is sharded; ``eta_r`` is replicated, so XLA all-reduces its
    gradient as part of the backward pass (the "config 4" pattern:
    differentiable coverage map -> gradient descent on permittivity).
    """

    def loss_fn(eta: Array) -> Array:
        power = sharded_power_map(
            scene,
            frequency,
            mesh,
            order=order,
            eta_r=eta,
            conductivity=conductivity,
        )
        power_db = 10.0 * jnp.log10(jnp.maximum(power, 1e-30))
        return jnp.mean((power_db - target_power) ** 2)

    loss, grad = jax.value_and_grad(loss_fn)(eta_r)
    return eta_r - learning_rate * grad, loss


def placement_training_step(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    mesh: Mesh,
    *,
    order: int,
    tx: Float[Array, "num_tx 3"],
    eta_r: Float[Array, " num_materials"],
    conductivity: Float[Array, " num_materials"],
    target_power: Float[Array, "..."] | None = None,
    tx_learning_rate: float = 1e-1,
    eta_learning_rate: float = 1e-2,
) -> tuple[Float[Array, "num_tx 3"], Float[Array, " num_materials"], Float[Array, ""]]:
    """One SPMD gradient step on TX positions AND material permittivity.

    The BASELINE config-5 pattern: the RX axis is sharded across the
    device mesh; TX positions and ``eta_r`` are replicated, so XLA
    all-reduces their gradients as part of the backward pass.
    Gradients flow into the TX coordinates through the image method (path
    geometry depends on TX) and the EM chain (departure directions,
    spreading, phase); path-validity masks are boolean and act as frozen
    selectors, exactly as in the reference's differentiability contract.

    With ``target_power`` (dB), minimizes the dB MSE; without it,
    maximizes mean received power over the RX grid (coverage-optimal TX
    placement).
    """

    def loss_fn(params: dict[str, Array]) -> Array:
        import differt_tpu.treekit as tk

        s = tk.tree_at(lambda sc: sc.transmitters, scene, params["tx"])
        power = sharded_power_map(
            s,
            frequency,
            mesh,
            order=order,
            eta_r=params["eta_r"],
            conductivity=conductivity,
        )
        power_db = 10.0 * jnp.log10(jnp.maximum(power, 1e-30))
        if target_power is not None:
            return jnp.mean((power_db - target_power) ** 2)
        return -jnp.mean(power_db)

    params = {"tx": tx, "eta_r": eta_r}
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return (
        tx - tx_learning_rate * grads["tx"],
        eta_r - eta_learning_rate * grads["eta_r"],
        loss,
    )


def _tile_amplitude_parts(
    scene_tile, tx, eta_r, rx_tile, cand, itypes, valid,
    frequency, conductivity, thickness, batch_size,
    smoothing_factor=None,
):
    """(real, imag) of one (RX tile, candidate chunk) amplitude sum.

    Real pairs instead of complex so the streamed VJP below composes with
    the loss cotangent without any Wirtinger-convention bookkeeping.
    """
    from ..coverage import _coverage_tile

    a = _coverage_tile(
        scene_tile,
        tx,
        rx_tile,
        cand,
        itypes,
        valid,
        frequency,
        eta_r,
        conductivity,
        thickness,
        None,
        True,
        batch_size,
        smoothing_factor,
    )
    return jnp.real(a), jnp.imag(a)


def _streamed_tile_grad(
    scene_tile, tx, eta_r, rx_tile, cand, itypes, valid,
    frequency, conductivity, thickness, g_re, g_im, batch_size,
    smoothing_factor=None,
):
    """VJP of one tile's amplitude w.r.t. (tx, eta_r), jitted once.

    Module-level (stable jit identity) for the same reason as
    ``coverage._coverage_tile``: a per-call closure would recompile the
    fused trace+EM+transpose graph on every invocation.
    """

    def f(tx_, eta_):
        return _tile_amplitude_parts(
            scene_tile, tx_, eta_, rx_tile, cand, itypes, valid,
            frequency, conductivity, thickness, batch_size,
            smoothing_factor,
        )

    _, vjp = jax.vjp(f, tx, eta_r)
    return vjp((g_re, g_im))


def _jit_tile_grad():
    import differt_tpu.treekit as tk

    return tk.filter_jit(_streamed_tile_grad)


_TILE_GRAD = None


def _streamed_setup(
    scene,
    frequency,
    mesh,
    tx,
    eta_r,
    conductivity,
    thickness,
    path_candidates,
    candidate_chunk,
    rx_chunk,
):
    """Shared padding/replication/tiling setup of the streamed steps."""
    import differt_tpu.treekit as tk

    from ..coverage import _resolve_materials

    frequency = jnp.asarray(frequency)
    eta_r, conductivity, thickness = _resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )

    rx_all = scene.receivers.reshape(-1, 3)
    num_rx = rx_all.shape[0]
    rx_chunk = min(rx_chunk, max(num_rx, 1))
    pad_r = (-num_rx) % rx_chunk
    if pad_r:
        rx_all = jnp.concatenate(
            (rx_all, jnp.broadcast_to(rx_all[:1], (pad_r, 3))), axis=0
        )

    # One candidate array per interaction order: a sequence streams every
    # order's chunks through the same per-tile step, so the accumulated
    # amplitude (and hence the loss and its gradients) is the COHERENT
    # multi-order sum — the physically meaningful coverage objective.
    cand_list = (
        list(path_candidates)
        if isinstance(path_candidates, (list, tuple))
        else [path_candidates]
    )
    prepared = []
    for cand in cand_list:
        cand = jnp.asarray(cand)
        n = cand.shape[0]
        chunk = min(candidate_chunk, max(n, 1))
        pad = (-n) % chunk
        if pad:
            cand = jnp.concatenate(
                (cand, jnp.broadcast_to(cand[:1], (pad, cand.shape[1]))),
                axis=0,
            )
        prepared.append((cand, n, chunk))

    scene_tile = tk.tree_at(
        lambda s: s.receivers, scene, jnp.zeros((0, 3), rx_all.dtype)
    )
    if mesh is not None:
        scene_tile = replicate(scene_tile, mesh)
        tx = replicate(tx, mesh)
        eta_r = replicate(eta_r, mesh)
        conductivity = replicate(conductivity, mesh)

    def tiles():
        for row, r0 in enumerate(range(0, rx_all.shape[0], rx_chunk)):
            rx_tile = rx_all[r0 : r0 + rx_chunk]
            if mesh is not None:
                rx_tile = shard_along(rx_tile, mesh, axis=0)
            for cand, n, chunk in prepared:
                for c0 in range(0, cand.shape[0], chunk):
                    chunk_valid = jnp.arange(c0, c0 + chunk) < n
                    part = cand[c0 : c0 + chunk]
                    yield (
                        row,
                        rx_tile,
                        part,
                        jnp.zeros_like(part, dtype=jnp.int32),
                        chunk_valid,
                    )

    return (
        frequency,
        tx,
        eta_r,
        conductivity,
        thickness,
        scene_tile,
        tiles,
        num_rx,
        rx_chunk,
        pad_r,
    )


def _streamed_forward(
    scene_tile,
    tiles,
    tx,
    frequency,
    eta_r,
    conductivity,
    thickness,
    num_rx,
    rx_chunk,
    batch_size,
    smoothing_factor=None,
):
    """Pass 1: accumulate the per-pixel coherent amplitude sum tile-wise."""
    from ..coverage import _coverage_tile

    row_totals: dict[int, Array] = {}
    for row, rx_tile, cand, it, valid in tiles():
        part = _coverage_tile(
            scene_tile,
            tx,
            rx_tile,
            cand,
            it,
            valid,
            frequency,
            eta_r,
            conductivity,
            thickness,
            None,
            True,
            batch_size,
            smoothing_factor,
        )
        row_totals[row] = part if row not in row_totals else row_totals[row] + part
    total = jnp.concatenate(
        [row_totals[r] for r in sorted(row_totals)], axis=-1
    )
    return total[..., :num_rx]


def _placement_loss_fn(target_power):
    from ..em import z_0

    def loss_of(parts: tuple[Array, Array]) -> Array:
        re, im = parts
        power = (re**2 + im**2) / z_0
        power_db = 10.0 * jnp.log10(jnp.maximum(power, 1e-30))
        if target_power is not None:
            return jnp.mean((power_db - jnp.asarray(target_power)) ** 2)
        return -jnp.mean(power_db)

    return loss_of


def streamed_placement_loss(
    scene: Scene,
    frequency: Float[ArrayLike, ""],
    mesh: Mesh | None,
    *,
    tx: Float[Array, "num_tx 3"],
    eta_r: Float[Array, " num_materials"],
    conductivity: Float[Array, " num_materials"],
    thickness: Float[Array, " num_materials"] | None = None,
    path_candidates: Array | Sequence[Array],
    candidate_chunk: int = 256,
    rx_chunk: int = 8192,
    target_power: Float[Array, "..."] | None = None,
    batch_size: int | None = 512,
    return_db_map: bool = False,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
) -> Float[Array, "..."]:
    """The streamed placement LOSS at ``tx`` — no gradient pass.

    Identical forward semantics to :func:`streamed_placement_step` (same
    tiling, same coherent accumulation, same dB loss), exposed separately
    so a finite-difference probe can evaluate the loss at perturbed TX
    positions and anchor the streamed gradient's direction (the chip-side
    check recorded by ``scaling.py --config5``).

    With ``return_db_map=True`` the UNREDUCED per-pixel dB power
    ``[num_tx, num_rx]`` is returned instead of its mean: a
    finite-difference probe whose loss delta is a few float32 ULPs of the
    mean (the city-scale situation: ``|g| h ~ 1e-4`` against a ~260 dB
    mean) must take the mean in float64 on the host to resolve it.
    """
    (
        frequency,
        tx,
        eta_r,
        conductivity,
        thickness,
        scene_tile,
        tiles,
        num_rx,
        rx_chunk,
        _,
    ) = _streamed_setup(
        scene,
        frequency,
        mesh,
        tx,
        eta_r,
        conductivity,
        thickness,
        path_candidates,
        candidate_chunk,
        rx_chunk,
    )
    total = _streamed_forward(
        scene_tile,
        tiles,
        tx,
        frequency,
        eta_r,
        conductivity,
        thickness,
        num_rx,
        rx_chunk,
        batch_size,
        None if smoothing_factor is None else jnp.asarray(smoothing_factor),
    )
    if return_db_map:
        power = (jnp.real(total) ** 2 + jnp.imag(total) ** 2)
        from ..em import z_0

        power = power / z_0
        return 10.0 * jnp.log10(jnp.maximum(power, 1e-30))
    loss_of = _placement_loss_fn(target_power)
    return loss_of((jnp.real(total), jnp.imag(total)))


def streamed_placement_step(

    scene: Scene,
    frequency: Float[ArrayLike, ""],
    mesh: Mesh | None,
    *,
    tx: Float[Array, "num_tx 3"],
    eta_r: Float[Array, " num_materials"],
    conductivity: Float[Array, " num_materials"],
    thickness: Float[Array, " num_materials"] | None = None,
    path_candidates: Array | Sequence[Array],
    candidate_chunk: int = 256,
    rx_chunk: int = 8192,
    target_power: Float[Array, "..."] | None = None,
    tx_learning_rate: float = 1e-1,
    eta_learning_rate: float = 1e-2,
    batch_size: int | None = 512,
    smoothing_factor: Float[ArrayLike, ""] | None = None,
) -> tuple[
    Float[Array, "num_tx 3"], Float[Array, " num_materials"], Float[Array, ""]
]:
    """One TX-placement + permittivity gradient step streamed over the grid.

    :func:`placement_training_step` differentiates through a coverage map
    materialized whole — impossible at city scale (16 TX x 10^6 RX x
    candidates). This variant streams BOTH passes through fixed-size
    (RX tile, candidate chunk) buffers:

    1. Forward: accumulate the per-pixel coherent amplitude sum tile by
       tile (the :func:`differt_tpu.coverage.power_map_chunked` loop).
    2. The loss touches only that accumulated ``[num_tx, num_rx]`` array,
       so its cotangent is one cheap elementwise pass. Without a
       ``target_power`` the loss is the negated mean dB power
       (coverage-optimal placement); with one, the dB MSE.
    3. Backward: re-run each tile under ``jax.vjp`` with its cotangent
       slice, accumulating TX/permittivity gradients — the total is a
       plain sum of tile contributions, so the chunked VJP sum is the
       exact full-grid gradient (validated against the unstreamed step
       in tests/test_parallel.py).

    Peak memory is O(candidate_chunk x rx_chunk) regardless of grid size.
    With a device ``mesh``, every RX tile is sharded across it while TX
    and materials stay replicated, so XLA all-reduces their per-tile
    gradients inside the jitted tile step.
    """
    global _TILE_GRAD
    if _TILE_GRAD is None:
        _TILE_GRAD = _jit_tile_grad()

    (
        frequency,
        tx,
        eta_r,
        conductivity,
        thickness,
        scene_tile,
        tiles,
        num_rx,
        rx_chunk,
        pad_r,
    ) = _streamed_setup(
        scene,
        frequency,
        mesh,
        tx,
        eta_r,
        conductivity,
        thickness,
        path_candidates,
        candidate_chunk,
        rx_chunk,
    )

    smoothing_factor = (
        None if smoothing_factor is None else jnp.asarray(smoothing_factor)
    )
    total = _streamed_forward(
        scene_tile,
        tiles,
        tx,
        frequency,
        eta_r,
        conductivity,
        thickness,
        num_rx,
        rx_chunk,
        batch_size,
        smoothing_factor,
    )

    # Pass 2: loss + cotangent on the accumulated totals only.
    loss_of = _placement_loss_fn(target_power)
    loss, (g_re, g_im) = jax.value_and_grad(loss_of)(
        (jnp.real(total), jnp.imag(total))
    )
    if pad_r:
        zeros = jnp.zeros((g_re.shape[0], pad_r), g_re.dtype)
        g_re = jnp.concatenate((g_re, zeros), axis=-1)
        g_im = jnp.concatenate((g_im, zeros), axis=-1)

    # Pass 3: per-tile VJPs, accumulated.
    g_tx = jnp.zeros_like(tx)
    g_eta = jnp.zeros_like(eta_r)
    for row, rx_tile, cand, it, valid in tiles():
        sl = slice(row * rx_chunk, (row + 1) * rx_chunk)
        d_tx, d_eta = _TILE_GRAD(
            scene_tile,
            tx,
            eta_r,
            rx_tile,
            cand,
            it,
            valid,
            frequency,
            conductivity,
            thickness,
            g_re[:, sl],
            g_im[:, sl],
            batch_size,
            smoothing_factor,
        )
        g_tx = g_tx + d_tx
        g_eta = g_eta + d_eta

    return (
        tx - tx_learning_rate * g_tx,
        eta_r - eta_learning_rate * g_eta,
        loss,
    )
