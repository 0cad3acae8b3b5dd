"""Run the tracer's main path on an NVIDIA GPU and check it against the CPU.

    python chip_smoke.py            # one GPU: phases 1-5
    python chip_smoke.py --multi    # four GPUs: phase 1 and phase 6 only

The scene is the procedural city ``scenes.urban_scene(24, 24)`` (about 17k
triangles, building heights drawn from ``--seed``), traced with order-2
specular paths and the Jones-chain EM model at 3.5 GHz.

1. device    platform, card name and power limit, JAX version, compile cache.
             Exits non-zero unless JAX's first device is a GPU: nothing here
             ever continues on the CPU.
2. kernels   the Pallas any-hit and closest-hit kernels, compiled for the
             card, against the plain-JAX scans on the card: 2^20 rays x the
             city mesh, with both times.
3. forward   ``power_map_chunked`` over 4096 order-2 candidates x a 64 x 64
             RX grid (600 m square around the TX), then ``Scene.trace_paths`` + ``received_power`` and
             ``power_map_chunked`` on a 256-candidate x 256-RX subset, which
             is compared with the same calls run on the CPU device of this
             process under the "jax" backend.
4. gradient  one ``streamed_placement_step`` at full size; the subset's step
             is compared with the CPU's.
5. sbr       ``Scene.launch_paths(order=2, solver="sbr")`` with 2^18 rays
             (closest-hit kernel), compared with the CPU.
6. multi     (``--multi``) ``sharded_power_map`` and one
             ``placement_training_step`` on a 4-GPU mesh with the RX axis
             sharded, compared with the same calls on a 1-GPU mesh.

Precision and tolerances. Everything is float32; the matrix products of the
geometry and EM code ask for ``Precision.HIGHEST``, so no TF32 enters.
GPU and CPU still differ in fused multiply-adds and summation order, so:

- ray casts: masks equal except at grazing hits, i.e. rays whose float64
  barycentric or distance margin to some triangle is below 1e-4; at most
  1e-5 of the rays may be grazing. Closest-hit ``t`` within rtol 1e-5;
  indices equal unless the two distances tie within that tolerance.
- path masks equal on at least 99.99 % of (tx, rx, candidate) entries;
  vertices of paths valid on both within 1e-4 of the scene extent.
- linear power within rtol 1e-3 wherever it is above 1e-12 of its maximum,
  on receivers whose path masks agree.
- gradients within a relative L2 error of 1e-2, loss within rtol 1e-3.
- SBR: first-bounce differences only at ties or grazing hits; a later
  bounce starts on the triangle just hit, and may re-hit it at a distance
  near epsilon, a decision rounding can flip, so ray paths may diverge
  there or at a tie, and elsewhere for at most 1e-3 of the rays; hit
  points of agreeing rays within 1e-4 of the scene extent.
- multi: 4-GPU results within rtol 1e-4 (power) and 1e-3 (loss, gradients)
  of the 1-GPU results, and the output split in four equal shards on four
  distinct devices.

Each phase prints one line of its own numbers. Any failure exits non-zero
without the result line. The last line of standard output is, on success,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

FREQUENCY = 3.5e9
ETA_R = (5.24,)
CONDUCTIVITY = (0.123,)
NUM_BLOCKS = 24
KERNEL_RAYS = 1 << 20
SBR_RAYS = 1 << 18
NUM_CANDIDATES = 4096
GRID = 64
SUB_CANDIDATES = 256
SUB_GRID = 16
CANDIDATE_CHUNK = 4096
RX_CHUNK = 128
TX = (0.0, 0.0, 10.0)
FULL_HALF_WIDTH = 300.0
SUB_HALF_WIDTH = 40.0


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def line(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def timed(fn, repeats: int = 3):
    """``(result, best seconds)``: one warm-up call, then the best of a few."""
    import jax

    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - start)
    return out, best


def to_device(tree, device):
    import jax

    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, device) if isinstance(x, jax.Array) else x, tree
    )


@contextlib.contextmanager
def on_cpu():
    """The CPU device of this process, with the plain-JAX ray casts."""
    import jax

    from differt_tpu.ops import set_backend

    set_backend("jax")
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield jax.devices("cpu")[0]
    finally:
        set_backend("auto")


# -- Scene and inputs --------------------------------------------------------


def make_scene(seed: int):
    import jax
    import jax.numpy as jnp

    import differt_tpu.treekit as tk
    from differt_tpu.scenes import urban_scene

    start = time.perf_counter()
    scene = urban_scene(NUM_BLOCKS, NUM_BLOCKS, key=jax.random.key(seed))
    scene = tk.tree_at(lambda s: s.transmitters, scene, jnp.array([TX]))
    jax.block_until_ready(scene.mesh.vertices)
    return scene, time.perf_counter() - start


def city_extent() -> float:
    """Width of the building area (the ground plane reaches twice as far)."""
    return 50.0 * NUM_BLOCKS


def rx_grid(n: int, half_width: float):
    """``n x n`` receivers 1.5 m above the ground, centred under the TX."""
    import jax.numpy as jnp

    x, y = jnp.meshgrid(
        jnp.linspace(-half_width, half_width, n) + TX[0],
        jnp.linspace(-half_width, half_width, n) + TX[1],
    )
    return jnp.stack((x, y, jnp.full_like(x, 1.5)), axis=-1)


def order2_candidates(scene, count: int, seed: int):
    """Seeded order-2 candidates among the faces around the TX.

    Every ordered pair of distinct faces among the ground (the last two
    triangles) and the building triangles closest to the TX, shuffled with
    ``seed`` and cut to ``count``: street-canyon and ground bounces, a good
    share of which are valid paths for receivers near the TX.
    """
    import jax
    import jax.numpy as jnp

    num_buildings = int(scene.mesh.num_triangles) - 2
    num_near = int(np.ceil(np.sqrt(count))) + 1 - 2
    centroids = scene.mesh.triangle_vertices[:num_buildings].mean(axis=1)
    dist = jnp.linalg.norm(centroids - jnp.asarray(TX), axis=-1)
    near = jnp.argsort(dist)[:num_near].astype(jnp.int32)
    faces = jnp.concatenate((near, jnp.array([num_buildings, num_buildings + 1])))
    a, b = jnp.meshgrid(faces, faces, indexing="ij")
    pairs = jnp.stack((a.ravel(), b.ravel()), axis=-1)
    pairs = pairs[np.asarray(pairs[:, 0] != pairs[:, 1])]
    order = jax.random.permutation(jax.random.key(seed + 1), pairs.shape[0])
    return pairs[order[:count]]


# -- Ray-cast comparisons ----------------------------------------------------


def grazing_rays(o, d, tris, threshold, epsilon, rays) -> np.ndarray:
    """Which of ``rays`` have a float64 hit margin below 1e-4 on some triangle.

    The margin of a (ray, triangle) pair is the distance of its barycentric
    coordinates and its distance parameter to the edges of the hit region
    ``u, v >= 0, u + v <= 1, epsilon < t < threshold`` (``t`` relative to
    ``max(t, 1)``), or of ``|det|`` to ``epsilon``.
    """
    out = np.zeros(len(rays), dtype=bool)
    v0 = tris[:, 0].astype(np.float64)
    e1 = tris[:, 1].astype(np.float64) - v0
    e2 = tris[:, 2].astype(np.float64) - v0
    for n, r in enumerate(rays):
        oo = o[r].astype(np.float64)
        dd = d[r].astype(np.float64)
        h = np.cross(dd, e2)
        det = np.sum(h * e1, axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / det
            s = oo - v0
            u = inv * np.sum(s * h, axis=-1)
            q = np.cross(s, e1)
            v = inv * np.sum(q * dd, axis=-1)
            t = inv * np.sum(q * e2, axis=-1)
            scale = np.maximum(np.abs(t), 1.0)
            margins = np.stack(
                (u, v, 1.0 - u - v, (t - epsilon) / scale, (threshold[n] - t) / scale)
            )
        near_region = np.nan_to_num(np.min(margins, axis=0), nan=-1.0) > -1e-4
        on_edge = np.any(np.abs(np.nan_to_num(margins, nan=1.0)) < 1e-4, axis=0)
        det_edge = np.abs(np.abs(det) - epsilon) < 1e-4 * np.maximum(np.abs(det), 1.0)
        out[n] = bool(np.any(near_region & (on_edge | det_edge)))
    return out


def phase_kernels(scene, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from differt_tpu.ops._pallas_rt import (
        pallas_first_triangle_hit_by_ray,
        pallas_ray_intersect_any_triangle,
    )
    from differt_tpu.rt import first_triangle_hit_by_ray, ray_intersect_any_triangle

    tv = scene.mesh.triangle_vertices
    n = KERNEL_RAYS
    half = 0.5 * city_extent()
    k1, k2, k3 = jax.random.split(jax.random.key(seed + 2), 3)
    lo = jnp.array([-half, -half, 1.5])
    hi = jnp.array([half, half, 60.0])
    origins = jax.random.uniform(k1, (n, 3), minval=lo, maxval=hi)
    ends = jax.random.uniform(k2, (n, 3), minval=lo, maxval=hi)
    segments = ends - origins
    unit = jax.random.normal(k3, (n, 3))
    unit = unit / jnp.linalg.norm(unit, axis=-1, keepdims=True)
    eps = 10.0 * float(jnp.finfo(jnp.float32).eps)
    hit_tol = 100.0 * float(jnp.finfo(jnp.float32).eps)
    thr = 1.0 - 2.0 * hit_tol
    shifted = origins + segments * hit_tol

    any_kernel = jax.jit(
        lambda o, d: pallas_ray_intersect_any_triangle(o, d, tv, hit_threshold=thr)
    )
    any_scan = jax.jit(
        lambda o, d: ray_intersect_any_triangle(
            o, d, tv, hit_tol=2.0 * hit_tol, batch_size=256
        )
    )
    close_kernel = jax.jit(lambda o, d: pallas_first_triangle_hit_by_ray(o, d, tv))
    close_scan = jax.jit(
        lambda o, d: first_triangle_hit_by_ray(o, d, tv, batch_size=256)
    )
    blocked_k, t_any_k = timed(lambda: any_kernel(shifted, segments))
    blocked_s, t_any_s = timed(lambda: any_scan(shifted, segments))
    (idx_k, t_k), t_close_k = timed(lambda: close_kernel(origins, unit))
    (idx_s, t_s), t_close_s = timed(lambda: close_scan(origins, unit))

    tris = np.asarray(tv)
    o_np, seg_np, unit_np = map(np.asarray, (shifted, segments, unit))
    blocked_k, blocked_s = np.asarray(blocked_k), np.asarray(blocked_s)
    diff = np.flatnonzero(blocked_k != blocked_s)
    grazing = grazing_rays(o_np, seg_np, tris, np.full(len(diff), thr), eps, diff)
    check(bool(grazing.all()), f"any-hit: {int((~grazing).sum())} non-grazing mismatches")
    check(len(diff) <= 1e-5 * n, f"any-hit: {len(diff)} grazing rays > 1e-5 of {n}")

    idx_k, t_k, idx_s, t_s = map(np.asarray, (idx_k, t_k, idx_s, t_s))
    o_np = np.asarray(origins)
    both = (idx_k >= 0) & (idx_s >= 0)
    gap = np.abs(np.where(both, t_k, 0.0) - np.where(both, t_s, 0.0))
    t_close = both & (gap <= 1e-5 * np.abs(t_s))
    suspect = np.flatnonzero(((idx_k >= 0) != (idx_s >= 0)) | (both & ~t_close))
    far = np.full(len(suspect), np.inf)
    c_grazing = grazing_rays(o_np, unit_np, tris, far, eps, suspect)
    check(bool(c_grazing.all()), f"closest-hit: {int((~c_grazing).sum())} non-grazing mismatches")
    check(len(suspect) <= 1e-5 * n, f"closest-hit: {len(suspect)} grazing rays > 1e-5 of {n}")
    ties = both & t_close & (idx_k != idx_s)
    line(
        "kernels",
        rays=n,
        triangles=int(tv.shape[0]),
        anyhit_kernel_s=t_any_k,
        anyhit_scan_s=t_any_s,
        anyhit_blocked=int(blocked_k.sum()),
        anyhit_grazing=len(diff),
        closest_kernel_s=t_close_k,
        closest_scan_s=t_close_s,
        closest_hits=int((idx_k >= 0).sum()),
        closest_grazing=len(suspect),
        closest_index_ties=int(ties.sum()),
    )


# -- Forward, gradient, SBR ---------------------------------------------------


def materials():
    import jax.numpy as jnp

    return jnp.array(ETA_R), jnp.array(CONDUCTIVITY)


def forward_subset(scene, cands):
    """Trace + EM and the chunked map on the subset, on the current device."""
    import jax.numpy as jnp

    from differt_tpu.coverage import power_map_chunked, received_power

    eta_r, conductivity = materials()
    paths = scene.trace_paths(path_candidates=cands)
    power = received_power(
        paths, scene, FREQUENCY, eta_r=eta_r, conductivity=conductivity
    )
    chunked = power_map_chunked(
        scene,
        FREQUENCY,
        path_candidates=cands,
        eta_r=eta_r,
        conductivity=conductivity,
        candidate_chunk=SUB_CANDIDATES,
        rx_chunk=RX_CHUNK,
    )
    out = (paths.mask, paths.vertices, power, chunked)
    return tuple(np.asarray(jnp.asarray(x)) for x in out)


def phase_forward(scene, cands, sub_scene, sub_cands) -> None:
    from differt_tpu.coverage import power_map_chunked

    import differt_tpu.treekit as tk

    eta_r, conductivity = materials()
    full_scene = tk.tree_at(lambda s: s.receivers, scene, rx_grid(GRID, FULL_HALF_WIDTH))
    full, t_full = timed(
        lambda: power_map_chunked(
            full_scene,
            FREQUENCY,
            path_candidates=cands,
            eta_r=eta_r,
            conductivity=conductivity,
            candidate_chunk=CANDIDATE_CHUNK,
            rx_chunk=RX_CHUNK,
        ),
        repeats=2,
    )
    full = np.asarray(full)
    check(full.shape == (1, GRID, GRID), f"power map shape {full.shape}")
    check(bool(np.isfinite(full).all()), "power map has non-finite values")
    check(bool((full > 0).any()), "power map is all zero")

    start = time.perf_counter()
    gpu = forward_subset(sub_scene, sub_cands)
    t_sub = time.perf_counter() - start
    with on_cpu() as cpu:
        start = time.perf_counter()
        ref = forward_subset(to_device(sub_scene, cpu), to_device(sub_cands, cpu))
        t_cpu = time.perf_counter() - start

    mask_g, vert_g, power_g, chunked_g = gpu
    mask_c, vert_c, power_c, chunked_c = ref
    agree = mask_g == mask_c
    check(agree.mean() >= 0.9999, f"path masks agree on {agree.mean():.6f} < 0.9999")
    both = mask_g & mask_c
    extent = 2.0 * city_extent()
    vert_err = float(np.max(np.abs(vert_g - vert_c)[both], initial=0.0))
    check(vert_err <= 1e-4 * extent, f"vertex error {vert_err} > 1e-4 x {extent}")
    rx_agree = agree.reshape(*agree.shape[:-1], -1).all(axis=-1)
    power_rtol = {}
    for name, got, want in (("received_power", power_g, power_c), ("chunked", chunked_g, chunked_c)):
        sel = rx_agree & (want > 1e-12 * want.max())
        check(bool(sel.any()), f"{name}: no receiver with power to compare")
        power_rtol[name] = float((np.abs(got - want)[sel] / want[sel]).max())
        check(power_rtol[name] <= 1e-3, f"{name}: power rtol {power_rtol[name]} > 1e-3")
    line(
        "forward",
        candidates=int(cands.shape[0]),
        rx=GRID * GRID,
        power_map_s=t_full,
        paths_per_s=cands.shape[0] * GRID * GRID / t_full,
        subset_gpu_s=t_sub,
        subset_cpu_s=t_cpu,
        valid_paths=int(mask_g.sum()),
        mask_mismatches=int((~agree).sum()),
        rx_with_mismatch=int((~rx_agree).sum()),
        max_vertex_err_m=vert_err,
        max_power_rtol=max(power_rtol.values()),
        receivers_compared=int((rx_agree & (power_c > 1e-12 * power_c.max())).sum()),
    )


def placement_step(scene, cands, candidate_chunk):
    import jax.numpy as jnp

    from differt_tpu.parallel import streamed_placement_step

    eta_r, conductivity = materials()
    tx0 = scene.transmitters.reshape(-1, 3) + jnp.array([3.0, -2.0, 0.0])
    lr_tx, lr_eta = 1e-1, 1e-2
    new_tx, new_eta, loss = streamed_placement_step(
        scene,
        FREQUENCY,
        None,
        tx=tx0,
        eta_r=eta_r,
        conductivity=conductivity,
        path_candidates=cands,
        candidate_chunk=candidate_chunk,
        rx_chunk=RX_CHUNK,
        tx_learning_rate=lr_tx,
        eta_learning_rate=lr_eta,
    )
    g_tx = (tx0 - new_tx) / lr_tx
    g_eta = (eta_r - new_eta) / lr_eta
    return tuple(np.asarray(x) for x in (loss, g_tx, g_eta))


def phase_gradient(scene, cands, sub_scene, sub_cands) -> None:
    import differt_tpu.treekit as tk

    full_scene = tk.tree_at(lambda s: s.receivers, scene, rx_grid(GRID, FULL_HALF_WIDTH))
    (loss, g_tx, g_eta), t_full = timed(
        lambda: placement_step(full_scene, cands, CANDIDATE_CHUNK), repeats=1
    )
    for name, x in (("loss", loss), ("tx gradient", g_tx), ("eta gradient", g_eta)):
        check(bool(np.isfinite(x).all()), f"{name} is not finite")
    check(bool(np.any(g_tx != 0)), "TX gradient is zero")
    check(bool(np.any(g_eta != 0)), "material gradient is zero")

    gpu = placement_step(sub_scene, sub_cands, SUB_CANDIDATES)
    with on_cpu() as cpu:
        ref = placement_step(to_device(sub_scene, cpu), to_device(sub_cands, cpu), SUB_CANDIDATES)
    loss_rtol = float(abs(gpu[0] - ref[0]) / abs(ref[0]))
    check(loss_rtol <= 1e-3, f"subset loss rtol {loss_rtol} > 1e-3")
    errs = []
    for got, want in zip(gpu[1:], ref[1:]):
        err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        errs.append(err)
        check(err <= 1e-2, f"subset gradient relative L2 error {err} > 1e-2")
    line(
        "gradient",
        step_s=t_full,
        loss=float(loss),
        tx_grad=np.round(g_tx.ravel(), 6).tolist(),
        eta_grad=np.round(g_eta.ravel(), 6).tolist(),
        subset_loss_rtol=loss_rtol,
        subset_tx_grad_rel_err=errs[0],
        subset_eta_grad_rel_err=errs[1],
    )


def launch(scene):
    launched = scene.launch_paths(order=2, solver="sbr", num_rays=SBR_RAYS)
    objects = np.asarray(launched.objects)[0, 0]  # [rays, order + 2]
    vertices = np.asarray(launched.vertices)[0, 0]
    return objects, vertices


def phase_sbr(scene) -> None:
    import jax.numpy as jnp

    import differt_tpu.treekit as tk

    rx = rx_grid(4, SUB_HALF_WIDTH).reshape(-1, 3)
    sbr_scene = tk.tree_at(lambda s: s.receivers, scene, rx)
    (objects, vertices), t_gpu = timed(lambda: launch(sbr_scene), repeats=1)
    with on_cpu() as cpu:
        start = time.perf_counter()
        objects_c, vertices_c = launch(to_device(sbr_scene, cpu))
        t_cpu = time.perf_counter() - start

    extent = 2.0 * city_extent()
    tx = np.asarray(jnp.asarray(TX))
    first = objects[:, 1] != objects_c[:, 1]
    d_g = np.linalg.norm(vertices[:, 1] - tx, axis=-1)
    d_c = np.linalg.norm(vertices_c[:, 1] - tx, axis=-1)
    tie = np.abs(d_g - d_c) <= 1e-5 * np.maximum(d_c, 1.0)
    odd = np.flatnonzero(first & ~tie)
    tris = np.asarray(scene.mesh.triangle_vertices)
    from differt_tpu.geometry import fibonacci_lattice, viewing_frustum

    # The first-bounce rays, rebuilt on the host for the grazing test.
    world = jnp.concatenate(
        (scene.mesh.triangle_vertices.reshape(-1, 3), sbr_scene.receivers.reshape(-1, 3))
    )
    dirs = np.asarray(
        fibonacci_lattice(SBR_RAYS, frustum=viewing_frustum(jnp.asarray(TX), world))
    )
    grazing = grazing_rays(
        np.broadcast_to(tx, dirs.shape), dirs, tris, np.full(len(odd), np.inf),
        10.0 * float(np.finfo(np.float32).eps), odd,
    )
    check(bool(grazing.all()), f"sbr: {int((~grazing).sum())} first-bounce mismatches not ties or grazing")
    # Later bounces start on the triangle just hit, which the launcher does
    # not exclude: a bounce can re-hit it at t ~ 1e-6..1e-5, and whether that
    # lands above epsilon depends on rounding (fused multiply-adds differ
    # between devices). A chain may diverge at such a self-hit, or at a tie
    # in distance; at nothing else.
    differ = objects != objects_c
    chain = ~differ.any(axis=-1)
    rows = np.flatnonzero(~chain)
    b = np.argmax(differ[rows], axis=-1)
    self_hit = (objects[rows, b - 1] >= 0) & (
        (objects[rows, b] == objects[rows, b - 1])
        | (objects_c[rows, b] == objects_c[rows, b - 1])
    )
    seg_g = np.linalg.norm(vertices[rows, b] - vertices[rows, b - 1], axis=-1)
    seg_c = np.linalg.norm(vertices_c[rows, b] - vertices_c[rows, b - 1], axis=-1)
    tie_b = np.abs(seg_g - seg_c) <= 1e-5 * np.maximum(seg_c, 1.0)
    unexplained = int((~(self_hit | tie_b | (b == 1))).sum())
    check(
        unexplained <= 1e-3 * SBR_RAYS,
        f"sbr: {unexplained} ray paths diverge without a self-hit or tie",
    )
    hit = chain & (objects[:, 1] >= 0)
    err = float(np.max(np.abs(vertices[:, 1:3] - vertices_c[:, 1:3])[hit], initial=0.0))
    check(err <= 1e-4 * extent, f"sbr: hit-point error {err} > 1e-4 x {extent}")
    line(
        "sbr",
        rays=SBR_RAYS,
        gpu_s=t_gpu,
        cpu_s=t_cpu,
        first_bounce_hits=int((objects[:, 1] >= 0).sum()),
        first_bounce_ties=int((first & tie).sum()),
        first_bounce_grazing=len(odd),
        chain_agreement=float(chain.mean()),
        diverged_at_self_hit=int(self_hit.sum()),
        diverged_at_tie=int((tie_b & ~self_hit).sum()),
        diverged_unexplained=unexplained,
        self_hit_rate=float(np.mean((objects[:, 2] == objects[:, 1]) & (objects[:, 1] >= 0))),
        max_hit_point_err_m=err,
    )


# -- Four GPUs -----------------------------------------------------------------


def phase_multi(scene) -> None:
    import jax
    import jax.numpy as jnp

    import differt_tpu.treekit as tk
    from differt_tpu.parallel import (
        make_device_mesh,
        placement_training_step,
        sharded_power_map,
    )

    check(len(jax.devices()) >= 4, f"--multi needs 4 GPUs, found {len(jax.devices())}")
    eta_r, conductivity = materials()
    grid = 32
    multi_scene = tk.tree_at(lambda s: s.receivers, scene, rx_grid(grid, FULL_HALF_WIDTH))
    tx0 = multi_scene.transmitters.reshape(-1, 3) + jnp.array([3.0, -2.0, 0.0])

    def run(num_devices):
        mesh = make_device_mesh(num_devices)
        power, t_power = timed(
            lambda: sharded_power_map(
                multi_scene, FREQUENCY, mesh, order=1,
                eta_r=eta_r, conductivity=conductivity,
            ),
            repeats=2,
        )
        step, t_step = timed(
            lambda: placement_training_step(
                multi_scene, FREQUENCY, mesh, order=1,
                tx=tx0, eta_r=eta_r, conductivity=conductivity,
            ),
            repeats=1,
        )
        return power, t_power, step, t_step

    power1, t_power1, step1, t_step1 = run(1)
    power4, t_power4, step4, t_step4 = run(4)

    shards = power4.addressable_shards
    devices = {s.device for s in shards}
    sizes = {s.data.size for s in shards}
    check(len(shards) == 4 and len(devices) == 4, f"power map on {len(devices)} devices")
    check(sizes == {power4.size // 4}, f"uneven shards {sorted(sizes)}")
    p1, p4 = np.asarray(power1), np.asarray(power4)
    sel = p1 > 1e-12 * p1.max()
    rel = float((np.abs(p4 - p1)[sel] / p1[sel]).max())
    check(rel <= 1e-4, f"4-GPU power rtol {rel} > 1e-4")
    errs = []
    for got, want in zip(step4, step1):
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        errs.append(err)
        check(err <= 1e-3, f"4-GPU training step relative error {err} > 1e-3")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in jax.devices()[:4]]
    line(
        "multi",
        rx=grid * grid,
        candidates=int(scene.mesh.num_triangles),
        power_1gpu_s=t_power1,
        power_4gpu_s=t_power4,
        step_1gpu_s=t_step1,
        step_4gpu_s=t_step4,
        shards=len(shards),
        power_rtol=rel,
        step_rel_errs=errs,
        peak_bytes_per_gpu=peaks,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--multi", action="store_true", help="run only the 4-GPU sharded phase"
    )
    args = parser.parse_args()

    import jax

    from differt_tpu.compile_cache import enable_compilation_cache

    cache_dir = enable_compilation_cache()
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(
            f"chip_smoke: JAX's first device is {platform!r}, not a GPU; "
            "this check runs only on the card.",
            file=sys.stderr,
        )
        return 2

    line(
        "device",
        devices=repr(devices),
        kind=repr(devices[0].device_kind),
        count=len(devices),
        jax=jax.__version__,
        cache=cache_dir,
    )
    print(nvidia_smi(), flush=True)

    from differt_tpu.ops import get_backend

    check(get_backend() == "pallas", f"backend {get_backend()!r} on the GPU")
    scene, t_build = make_scene(args.seed)
    num_tris = int(scene.mesh.num_triangles)
    line("scene", triangles=num_tris, build_s=t_build)

    if args.multi:
        phase_multi(scene)
    else:
        phase_kernels(scene, args.seed)
        import differt_tpu.treekit as tk

        cands = order2_candidates(scene, NUM_CANDIDATES, args.seed)
        sub_scene = tk.tree_at(
            lambda s: s.receivers, scene, rx_grid(SUB_GRID, SUB_HALF_WIDTH)
        )
        sub_cands = cands[:SUB_CANDIDATES]
        phase_forward(scene, cands, sub_scene, sub_cands)
        phase_gradient(scene, cands, sub_scene, sub_cands)
        phase_sbr(scene)

    print(
        json.dumps({
            "ok": True,
            "device": {
                "platform": platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
