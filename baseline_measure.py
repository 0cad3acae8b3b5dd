"""Self-measure DiffeRT (the reference) on CPU — the `vs_baseline` anchor.

The reference publishes no absolute numbers (BASELINE.md), so this script
times the reference's own pipeline — composed exclusively from reference
functions loaded in place from /root/reference (see
tests/reference_oracle/refchain.py) — on the same workloads bench.py
measures on the accelerator:

- config2_canyon: street-canyon geometry, order-2 exhaustive candidates,
  64x64 RX power map  -> paths/s and px/s.
- cityscale_bruxelles: bruxelles.obj (14.2k triangles, the reference's
  own "medium" benchmark scene), shape-matched to the accelerator headline
  (262 144 order-2 candidates x 128 RX in 4 096-candidate chunks): a
  subsample of identically-shaped chunks is timed and extrapolated
  linearly over the chunk count -> paths/s.

Results land in BASELINE_MEASURED.json (checked in); bench.py divides
its accelerator throughput by these to report an honest repo-on-accelerator vs
DiffeRT-on-CPU `vs_baseline`.

Run:  python baseline_measure.py        (forces the CPU backend itself)
"""

import json
import pathlib
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests.reference_oracle.loader import load_reference, reference_available  # noqa: E402
from tests.reference_oracle.refchain import ref_amplitudes, ref_trace  # noqa: E402

BRUXELLES = pathlib.Path("/root/reference/docs/source/notebooks/bruxelles.obj")
FREQUENCY = 2.4e9


def _canyon_geometry():
    from differt_tpu.scenes import street_canyon_scene

    scene = street_canyon_scene(with_ground=True)
    mesh = scene.mesh
    return (
        jnp.asarray(mesh.vertices),
        jnp.asarray(mesh.triangles),
        jnp.asarray(mesh.normals),
    )


def _rx_grid(x0, x1, y0, y1, m, n, height):
    x, y = jnp.meshgrid(jnp.linspace(x0, x1, m), jnp.linspace(y0, y1, n))
    return jnp.stack((x, y, jnp.full_like(x, height)), axis=-1).reshape(-1, 3)


def _time(fn, *args, repeat=3):
    out = fn(*args)  # warmup + compile
    float(np.asarray(out).sum())
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args)
        float(np.asarray(out).sum())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_config2(ref):
    verts, tris, normals = _canyon_geometry()
    num_triangles = tris.shape[0]
    from differt_tpu.geometry import generate_all_path_candidates

    candidates = jnp.asarray(
        np.asarray(generate_all_path_candidates(int(num_triangles), 2))
    )
    tx = jnp.array([[-30.0, 0.0, 5.0]])
    rx = _rx_grid(-45.0, 45.0, -8.0, 8.0, 64, 64, 1.5)
    eta_r = jnp.array([5.24])
    conductivity = jnp.array([0.12])
    face_materials = jnp.zeros((num_triangles,), dtype=jnp.int32)

    @jax.jit
    def power(tx, rx):
        full, mask = ref_trace(ref, verts, tris, normals, tx, rx, candidates)
        objects = jnp.broadcast_to(
            candidates, (*full.shape[:-2], candidates.shape[-1])
        )
        a = ref_amplitudes(
            ref,
            vertices=full,
            objects=objects,
            mask=mask,
            face_materials=face_materials,
            face_normals=normals,
            frequency=FREQUENCY,
            eta_r=eta_r,
            conductivity=conductivity,
        )
        return jnp.abs(a.sum(axis=-1)) ** 2

    elapsed = _time(power, tx, rx)
    num_px = int(rx.shape[0])
    num_paths = num_px * int(candidates.shape[0])
    return {
        "num_candidates": int(candidates.shape[0]),
        "num_px": num_px,
        "elapsed_s": round(elapsed, 4),
        "paths_per_s": round(num_paths / elapsed, 1),
        "px_per_s": round(num_px / elapsed, 1),
    }


def bench_cityscale(ref):
    """Shape-matched to bench.py's accelerator headline (262 144 cand x 128 RX).

    The FULL workload would take the reference ~4-5 h on CPU, so the
    measurement times a subsample of IDENTICALLY-SHAPED chunks and
    extrapolates linearly: every chunk is the exact (4096 candidates x
    128 RX) tile the device pipeline streams, the candidate decode is the
    same closed-form index shard, and the per-chunk work is shape-for-
    shape what bench.py times — only the chunk COUNT is scaled down.
    """
    from differt_tpu.geometry import generate_path_candidates
    from differt_tpu.io import load_obj

    mesh = load_obj(BRUXELLES)
    verts = jnp.asarray(mesh.vertices)
    tris = jnp.asarray(mesh.triangles)
    normals = jnp.asarray(mesh.normals)
    num_triangles = int(tris.shape[0])

    total_candidates = 262144
    chunk = 4096
    measured_chunks = 2
    candidates = jnp.asarray(
        np.asarray(
            generate_path_candidates(
                num_triangles, 2, size=chunk * measured_chunks
            )
        )
    )
    tx = jnp.array([[0.0, 0.0, 40.0]])
    # Same receiver layout as bench.py bench_cityscale row (a): a 16 x 8
    # grid over the mesh bounding box at 1.5 m.
    (min_x, min_y, _), (max_x, max_y, _) = mesh.bounding_box
    rx = _rx_grid(
        float(min_x), float(max_x), float(min_y), float(max_y), 16, 8, 1.5
    )
    eta_r = jnp.array([5.24])
    conductivity = jnp.array([0.12])
    face_materials = jnp.zeros((num_triangles,), dtype=jnp.int32)

    @jax.jit
    def tile(cand):
        full, mask = ref_trace(ref, verts, tris, normals, tx, rx, cand)
        objects = jnp.broadcast_to(cand, (*full.shape[:-2], cand.shape[-1]))
        a = ref_amplitudes(
            ref,
            vertices=full,
            objects=objects,
            mask=mask,
            face_materials=face_materials,
            face_normals=normals,
            frequency=FREQUENCY,
            eta_r=eta_r,
            conductivity=conductivity,
        )
        return a.sum(axis=-1)

    def run():
        acc = None
        for c0 in range(0, chunk * measured_chunks, chunk):
            part = tile(candidates[c0 : c0 + chunk])
            acc = part if acc is None else acc + part
        return jnp.abs(acc) ** 2

    elapsed = _time(run, repeat=1)
    measured_paths = int(rx.shape[0]) * chunk * measured_chunks
    paths_per_s = measured_paths / elapsed
    return {
        "num_triangles": num_triangles,
        "num_candidates": total_candidates,
        "num_rx": int(rx.shape[0]),
        "chunk": chunk,
        "measured_chunks": measured_chunks,
        "measured_elapsed_s": round(elapsed, 4),
        "elapsed_s_extrapolated": round(
            elapsed * total_candidates / (chunk * measured_chunks), 1
        ),
        "paths_per_s": round(paths_per_s, 1),
    }


def main():
    if not reference_available():
        msg = "reference sources not available; cannot self-measure baseline"
        raise SystemExit(msg)
    ref = load_reference()
    results = {
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "config2_canyon": bench_config2(ref),
    }
    if BRUXELLES.is_file():
        results["cityscale_bruxelles"] = bench_cityscale(ref)
    out = pathlib.Path(__file__).parent / "BASELINE_MEASURED.json"
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
