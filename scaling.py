"""Multi-device scaling harness (BASELINE config 5 pattern).

Measures sharded coverage-map throughput (paths/s) at 1, 2, 4, ... devices
and reports scaling efficiency. Runs on whatever devices are available —
the GPUs of one host, or virtual CPU devices for validation:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scaling.py

On several hosts, call ``jax.distributed.initialize()`` first (pass
``--distributed``); each host runs the same program SPMD.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp

from differt_tpu.compile_cache import enable_compilation_cache


def _city_scene(num_tx: int, grid: int):
    """The procedural city (about 17k triangles) with TX and RX grids."""
    import differt_tpu.treekit as tk
    from differt_tpu.geometry import Scene
    from differt_tpu.scenes import urban_scene

    mesh = urban_scene(24, 24).mesh
    (min_x, min_y, _), (max_x, max_y, _) = mesh.bounding_box
    side = int(num_tx**0.5)
    assert side * side == num_tx, "num_tx must be a square"
    margin_x = 0.15 * (max_x - min_x)
    margin_y = 0.15 * (max_y - min_y)
    gx, gy = jnp.meshgrid(
        jnp.linspace(min_x + margin_x, max_x - margin_x, side),
        jnp.linspace(min_y + margin_y, max_y - margin_y, side),
    )
    tx = jnp.stack((gx, gy, jnp.full_like(gx, 60.0)), axis=-1).reshape(-1, 3)
    scene = Scene(mesh=mesh)
    scene = tk.tree_at(lambda s: s.transmitters, scene, tx)
    return scene.with_receivers_grid(grid, grid, height=1.5)


def _strided_candidates(num_primitives: int, order: int, size: int):
    """``size`` candidates sampled uniformly across the whole space.

    The first ``size`` candidates of the closed-form decode all share the
    same leading primitive (an arbitrary triangle), which at city scale
    yields almost no geometrically valid paths — fine for pure throughput,
    useless for a gradient. Striding the decode start across the full
    space samples varied geometry instead.
    """
    from differt_tpu.geometry import (
        count_path_candidates,
        generate_path_candidates,
    )

    total = count_path_candidates(num_primitives, order)
    group = 8
    num_groups = max(size // group, 1)
    step = max(total // num_groups, 1)
    parts = [
        generate_path_candidates(
            num_primitives,
            order,
            start=min(g * step, total - group),
            size=group,
        )
        for g in range(num_groups)
    ]
    return jnp.concatenate(parts, axis=0)[:size]


def run_config5(
    out: str | None,
    *,
    num_tx: int = 16,
    grid: int = 1024,
    shard: int = 128,
    grad_shard: int | None = None,
    rx_chunk: int = 8192,
) -> dict:
    """BASELINE config 5 at city scale on the available device(s).

    16 TX x 1M RX (1024 x 1024 grid) on the procedural city (about 17k
    triangles), ORDER-3 reflections (the spec'd order — BASELINE.md row
    5), with the candidate axis streamed as a decoded shard (the full
    order-3 space is ~2.9e12 candidates; a shard is one strided slice of
    the same closed-form index decode every chip uses — the per-(tx, rx,
    candidate) workload is identical). Then ONE TX-placement +
    permittivity gradient step at ORDER 2, streamed over the SAME full RX
    grid via chunked VJP accumulation
    (parallel.streamed_placement_step), plus a chip-side central
    finite-difference anchor of the TX gradient's directional derivative
    on a strided RX subsample — so ``tx_grad_norm`` is evidence, not a
    liveness bit. Timed runs follow a warmup call so compilation is
    excluded.
    """
    import time

    from differt_tpu.coverage import power_map_chunked
    from differt_tpu.parallel import (
        make_device_mesh,
        streamed_placement_loss,
        streamed_placement_step,
    )

    order = 3
    scene = _city_scene(num_tx, grid)
    tx = scene.transmitters.reshape(-1, 3)
    num_triangles = int(scene.mesh.num_triangles)
    candidates = _strided_candidates(num_triangles, order, shard)
    # One concrete material (ITU-class values at 2.4 GHz), matching the
    # mesh's single material table.
    eta = jnp.array([5.24])
    sigma = jnp.array([0.123])

    def run(freq):
        out = power_map_chunked(
            scene,
            freq,
            path_candidates=candidates,
            eta_r=eta,
            conductivity=sigma,
            candidate_chunk=shard,
            rx_chunk=rx_chunk,
        )
        return jax.block_until_ready(out)

    run(2.4e9)  # Warmup: compile everything outside the timed run.
    start = time.perf_counter()
    run(2.4e9 + 1e3)  # Distinct input so nothing is cached.
    elapsed = time.perf_counter() - start
    paths = num_tx * grid * grid * shard

    # One full-grid TX-placement + permittivity gradient step (streamed)
    # over the COHERENT multi-order (1 + 2) amplitude sum: the order-1
    # shard gives the loss real power over much of the grid, the order-2
    # shard differentiates through genuine double-bounce paths — together
    # the gradient step exercises order >= 2 as BASELINE.md row 5 asks.
    mesh = make_device_mesh()
    grad_shard = max(shard, 256) if grad_shard is None else grad_shard
    grad_orders = (1, 2)
    # The order-1 shard must include the mesh's dominant reflectors (the
    # ground triangles — by far the largest by area) or nearly every pixel
    # sits at the -300 dB floor and the TX gradient drowns in float32
    # resolution. Striding alone misses them: the city's ground is its
    # last two triangles.
    import numpy as np

    tv = np.asarray(jax.device_get(scene.mesh.triangle_vertices))
    areas = np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1
    )
    top = np.argsort(areas)[-8:].astype(np.int32)
    order1 = jnp.concatenate(
        (
            jnp.asarray(top[:, None]),
            _strided_candidates(num_triangles, 1, grad_shard - top.size),
        ),
        axis=0,
    )
    grad_candidates = [
        order1,
        _strided_candidates(num_triangles, 2, grad_shard),
    ]

    # The tile VJP holds the traced-path residuals ([tx, rx, cand, L, 3])
    # for rx_chunk x grad_shard at once, so the gradient pass streams
    # narrower tiles than the forward.
    grad_rx_chunk = min(rx_chunk, 2048)

    def grad_step(freq):
        return streamed_placement_step(
            scene,
            freq,
            mesh if mesh.devices.size > 1 else None,
            tx=tx,
            eta_r=eta,
            conductivity=sigma,
            path_candidates=grad_candidates,
            candidate_chunk=grad_shard,
            rx_chunk=grad_rx_chunk,
            # Unit learning rates: the harness reports the raw gradient
            # (update = gradient), dodging float32 "x + tiny == x" underflow
            # in the moved-or-not check.
            tx_learning_rate=1.0,
            eta_learning_rate=1.0,
        )

    jax.block_until_ready(grad_step(2.4e9))  # Warmup: compile outside the timing.
    start = time.perf_counter()
    new_tx, new_eta, loss = jax.block_until_ready(grad_step(2.4e9 + 1e3))
    grad_elapsed = time.perf_counter() - start
    grad_paths = num_tx * grid * grid * len(grad_orders) * grad_shard

    # Device-side gradient anchors on a strided RX
    # subsample of the SAME grid. Three measurements, because a naive TX
    # finite difference CANNOT anchor a hard-mask ray tracer at city
    # scale: moving the TX flips path-validity masks at a high density,
    # and the jump-density drift dominates the smooth (autodiff-visible)
    # slope. Measured here and recorded honestly:
    #
    # 1. tx_cos_vs_direct: cosine between the STREAMED TX gradient and an
    #    independent direct jax.grad of the identical loss on the
    #    subsample — pins the streamed VJP accumulation (the machinery
    #    the artifact's tx_grad_norm comes from) against autodiff ground
    #    truth on the device.
    # 2. eta_fd: central difference on the PERMITTIVITY, which moves no
    #    geometry and flips no masks — the loss is smooth in eta, so FD
    #    must match the streamed material gradient. This anchors the
    #    whole EM/streaming chain end-to-end.
    # 3. tx_fd: the raw TX central difference, recorded with the smooth
    #    (autodiff) directional derivative for comparison — their gap IS
    #    the hard-mask discontinuity drift (the quantity the reference's
    #    sigmoid smoothing exists to recover).
    import differt_tpu.treekit as tk
    import numpy as np

    from differt_tpu.coverage import _coverage_tile
    from differt_tpu.em import z_0
    from differt_tpu.parallel import streamed_placement_loss as _sp_loss

    rx_flat = scene.receivers.reshape(-1, 3)
    stride = max(1, rx_flat.shape[0] // 4096)
    rx_sub = rx_flat[::stride]
    scene_sub = tk.tree_at(lambda s: s.receivers, scene, rx_sub)
    # The direct jax.grad comparison materializes the whole
    # [tx, rx, cand] pipeline (plus its VJP) — stride it further so the
    # residuals stay in device memory at 16 TX.
    rx_direct = rx_flat[:: max(1, rx_flat.shape[0] // 1024)]

    sub_tx, sub_eta, _ = streamed_placement_step(
        scene_sub,
        2.4e9,
        None,
        tx=tx,
        eta_r=eta,
        conductivity=sigma,
        path_candidates=grad_candidates,
        candidate_chunk=grad_shard,
        rx_chunk=grad_rx_chunk,
        tx_learning_rate=1.0,
        eta_learning_rate=1.0,
    )
    g_tx_sub = np.asarray(jax.device_get(tx)) - np.asarray(
        jax.device_get(sub_tx)
    )
    g_eta_sub = np.asarray(jax.device_get(eta)) - np.asarray(
        jax.device_get(sub_eta)
    )
    g_norm = float(np.linalg.norm(g_tx_sub))
    fd_check: dict = {"subsample_rx": int(rx_sub.shape[0])}

    scene_tile = tk.tree_at(
        lambda s: s.receivers, scene_sub, jnp.zeros((0, 3))
    )

    def direct_loss(tx_val, eta_val):
        total = None
        for cand in grad_candidates:
            for c0 in range(0, cand.shape[0], grad_shard):
                part_c = cand[c0 : c0 + grad_shard]
                part = _coverage_tile(
                    scene_tile,
                    tx_val,
                    jnp.asarray(rx_direct),
                    part_c,
                    jnp.zeros_like(part_c, dtype=jnp.int32),
                    jnp.ones((part_c.shape[0],), dtype=bool),
                    jnp.asarray(2.4e9),
                    eta_val,
                    sigma,
                    None,
                    None,
                    True,
                    512,
                )
                total = part if total is None else total + part
        power = (jnp.real(total) ** 2 + jnp.imag(total) ** 2) / z_0
        return -jnp.mean(10.0 * jnp.log10(jnp.maximum(power, 1e-30)))

    if g_norm > 0.0:
        # (1) streamed vs direct jax.grad (TX direction + magnitude) on
        # the further-strided rx_direct subsample (identical workloads on
        # both sides).
        scene_direct = tk.tree_at(lambda s: s.receivers, scene, rx_direct)
        d_tx, _, _ = streamed_placement_step(
            scene_direct,
            2.4e9,
            None,
            tx=tx,
            eta_r=eta,
            conductivity=sigma,
            path_candidates=grad_candidates,
            candidate_chunk=grad_shard,
            rx_chunk=grad_rx_chunk,
            tx_learning_rate=1.0,
            eta_learning_rate=1.0,
        )
        g_tx_streamed_d = np.asarray(jax.device_get(tx)) - np.asarray(
            jax.device_get(d_tx)
        )
        g_tx_direct = np.asarray(
            jax.device_get(jax.grad(direct_loss, argnums=0)(tx, eta))
        )
        cos = float(
            (g_tx_streamed_d * g_tx_direct).sum()
            / (
                np.linalg.norm(g_tx_streamed_d)
                * np.linalg.norm(g_tx_direct)
                + 1e-30
            )
        )
        fd_check["tx_cos_vs_direct"] = round(cos, 6)
        fd_check["tx_norm_ratio_vs_direct"] = round(
            float(np.linalg.norm(g_tx_streamed_d))
            / (float(np.linalg.norm(g_tx_direct)) + 1e-30),
            4,
        )

        def sub_loss_f64(tx_val, eta_val):
            db = _sp_loss(
                scene_sub,
                2.4e9,
                None,
                tx=tx_val,
                eta_r=eta_val,
                conductivity=sigma,
                path_candidates=grad_candidates,
                candidate_chunk=grad_shard,
                rx_chunk=grad_rx_chunk,
                return_db_map=True,
            )
            return -np.asarray(jax.device_get(db), dtype=np.float64).mean()

        # (2) FD on the permittivity: smooth in eta (no geometry/mask
        # dependence), so FD must agree with the streamed gradient.
        ge_norm = float(np.linalg.norm(g_eta_sub))
        u_eta = jnp.asarray(g_eta_sub / max(ge_norm, 1e-30))
        h_eta = 1e-2
        fd_eta = (
            sub_loss_f64(tx, eta + h_eta * u_eta)
            - sub_loss_f64(tx, eta - h_eta * u_eta)
        ) / (2.0 * h_eta)
        eta_rel = abs(fd_eta - ge_norm) / max(abs(ge_norm), 1e-30)
        fd_check["eta_fd"] = {
            "h": h_eta,
            "fd_directional": fd_eta,
            "analytic_directional": ge_norm,
            "rel_err": round(eta_rel, 4),
        }

        # (3) Raw TX central difference (recorded with interpretation).
        u = jnp.asarray(g_tx_sub / g_norm)
        h = 5e-4
        fd_tx = (
            sub_loss_f64(tx + h * u, eta) - sub_loss_f64(tx - h * u, eta)
        ) / (2.0 * h)
        fd_check["tx_fd"] = {
            "h_m": h,
            "fd_directional": fd_tx,
            "smooth_directional": g_norm,
            "note": (
                "fd - smooth = hard-mask validity-jump drift (not an "
                "implementation error)"
            ),
        }
        fd_check["ok"] = bool(cos > 0.99 and eta_rel < 0.1)
    else:
        fd_check.update({"ok": False, "reason": "zero subsample gradient"})

    result = {
        "config5": {
            "scene": "urban_scene(24,24)",
            "num_triangles": num_triangles,
            "num_tx": num_tx,
            "num_rx": grid * grid,
            "order": order,
            "candidate_shard": shard,
            "paths_per_run": paths,
            "elapsed_s": round(elapsed, 2),
            "paths_per_s": round(paths / elapsed, 1),
            "backend": jax.default_backend(),
            "num_devices": len(jax.devices()),
            "grad_step": {
                "order": max(grad_orders),
                "orders": list(grad_orders),
                "coherent_multi_order": True,
                "candidate_shard": grad_shard,
                "num_rx": grid * grid,
                "elapsed_s": round(grad_elapsed, 2),
                "fwd_bwd_paths_per_s": round(grad_paths / grad_elapsed, 1),
                "tx_grad_norm": float(
                    jnp.linalg.norm(jax.device_get(new_tx) - jax.device_get(tx))
                ),
                "eta_grad_norm": float(
                    jnp.linalg.norm(
                        jax.device_get(new_eta) - jax.device_get(eta)
                    )
                ),
                "loss": float(loss),
                "fd_check": fd_check,
            },
        }
    }
    print(json.dumps(result))
    if out:
        _merge_json(out, result)
    return result


def _merge_json(path: str, update: dict) -> None:
    import pathlib

    p = pathlib.Path(path)
    data = json.loads(p.read_text()) if p.is_file() else {}
    data.update(update)
    p.write_text(json.dumps(data, indent=1))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid", type=int, default=32)
    parser.add_argument("--order", type=int, default=2)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument(
        "--config5",
        action="store_true",
        help="Run BASELINE config 5 (16 TX x 1M RX city scale) instead.",
    )
    parser.add_argument("--num-tx", type=int, default=16)
    parser.add_argument("--grid5", type=int, default=1024)
    parser.add_argument("--shard", type=int, default=128)
    parser.add_argument("--grad-shard", type=int, default=None)
    parser.add_argument("--rx-chunk", type=int, default=8192)
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="Call jax.distributed.initialize() (multi-host pods).",
    )
    args = parser.parse_args()
    enable_compilation_cache()

    if args.distributed:
        jax.distributed.initialize()

    if args.config5:
        run_config5(
            args.out,
            num_tx=args.num_tx,
            grid=args.grid5,
            shard=args.shard,
            grad_shard=args.grad_shard,
            rx_chunk=args.rx_chunk,
        )
        if args.out:
            # Persist the N-virtual-device correctness-scaling table too
            # (clearly labeled virtual in the block itself): an 8-device
            # CPU-mesh run of the sharded pipeline, merged into the same
            # artifact under "device_scaling".
            import subprocess
            import sys

            env = dict(os.environ)
            env["JAX_PLATFORMS"] = "cpu"
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=8"
            ).strip()
            subprocess.run(
                [sys.executable, __file__, "--out", args.out],
                env=env,
                check=False,
                timeout=1800,
            )
        return

    import differt_tpu.treekit as tk
    from differt_tpu.geometry import count_path_candidates
    from differt_tpu.parallel import make_device_mesh, sharded_power_map
    from differt_tpu.profiling import timeit
    from differt_tpu.scenes import street_canyon_scene

    scene = street_canyon_scene().set_assume_quads()
    scene = tk.tree_at(
        lambda s: s.transmitters, scene, jnp.array([-30.0, 0.0, 20.0])
    )
    scene = scene.with_receivers_grid(args.grid, args.grid, height=1.5)

    num_candidates = count_path_candidates(
        scene.mesh.num_primitives, args.order
    )
    paths_per_run = num_candidates * scene.num_receivers

    num_devices = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= num_devices]

    results = []
    base_rate = None
    for n in counts:
        mesh = make_device_mesh(n)
        stats = timeit(
            lambda mesh=mesh: sharded_power_map(
                scene, 2.4e9, mesh, order=args.order
            ),
            repeats=args.repeats,
        )
        rate = paths_per_run / stats["min"]
        if base_rate is None:
            base_rate = rate
        efficiency = rate / (base_rate * n)
        results.append({
            "devices": n,
            "paths_per_s": round(rate, 1),
            "elapsed_s": round(stats["min"], 4),
            "scaling_efficiency": round(efficiency, 3),
        })
        print(json.dumps(results[-1]))

    # Virtual host-platform devices all share the same physical CPU cores:
    # throughput cannot scale there (the run validates sharding correctness
    # + compilation only); real scaling numbers require real devices.
    virtual = (
        jax.default_backend() == "cpu"
        and "host_platform_device_count" in os.environ.get("XLA_FLAGS", "")
    )
    summary = {
        "summary": results,
        "backend": jax.default_backend(),
        "paths_per_run": paths_per_run,
        "virtual_devices": virtual,
        "note": (
            "virtual devices share one physical CPU; efficiency is "
            "meaningful on real devices only"
        )
        if virtual
        else None,
    }
    print(json.dumps(summary))
    if args.out:
        _merge_json(args.out, {"device_scaling": summary})


if __name__ == "__main__":
    main()
