"""Tests for the coverage-map ops and DeepMIMO consistency."""

import chex
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differt_tpu.coverage import complex_amplitudes, power_map, received_power
from differt_tpu.em import z_0
from differt_tpu.geometry import Mesh, Scene
from differt_tpu.plugins import deepmimo

FREQUENCY = 2.4e9


@pytest.fixture(scope="module")
def canyon() -> Scene:
    mesh = Mesh.box(length=60.0, width=20.0, height=15.0, with_top=False)
    scene = Scene(
        transmitters=jnp.array([-20.0, 0.0, 5.0]),
        mesh=mesh.set_materials("Concrete"),
    )
    return scene.with_receivers_grid(5, 4, height=1.5)


def test_power_map_shape_and_positivity(canyon: Scene) -> None:
    coverage = power_map(canyon, FREQUENCY, order=1)
    assert coverage.shape == (4, 5)
    values = np.asarray(coverage)
    assert (values >= 0).all()
    assert (values > 0).any()


def test_power_map_matches_received_power(canyon: Scene) -> None:
    eta_r = jnp.array([5.24])
    sigma = jnp.array([0.1])
    via_map = power_map(
        canyon, FREQUENCY, order=1, eta_r=eta_r, conductivity=sigma
    )
    paths = canyon.trace_paths(order=1)
    via_power = received_power(
        paths, canyon, FREQUENCY, eta_r=eta_r, conductivity=sigma
    )
    chex.assert_trees_all_close(via_map.reshape(-1), via_power.reshape(-1))


def test_coherent_vs_noncoherent(canyon: Scene) -> None:
    eta_r = jnp.array([5.24])
    sigma = jnp.array([0.1])
    paths = canyon.trace_paths(order=1)
    coherent = received_power(
        paths, canyon, FREQUENCY, eta_r=eta_r, conductivity=sigma, coherent=True
    )
    noncoherent = received_power(
        paths, canyon, FREQUENCY, eta_r=eta_r, conductivity=sigma, coherent=False
    )
    # Non-coherent sums magnitudes: immune to cancellation, so it upper-
    # bounds the coherent fades on average, and both are positive.
    assert float(noncoherent.mean()) > 0
    assert float(coherent.mean()) > 0


def test_amplitudes_match_deepmimo_export(canyon: Scene) -> None:
    # The coverage pipeline and the DeepMIMO exporter implement the same
    # physics: per-path powers must agree.
    paths = canyon.trace_paths(order=1)
    eta_r = jnp.array([float(5.24)])
    sigma = jnp.array([0.1])

    a = complex_amplitudes(
        paths, canyon, FREQUENCY, eta_r=eta_r, conductivity=sigma
    )
    power_cov = np.asarray(jnp.abs(a) ** 2 / z_0).reshape(1, -1, a.shape[-1])

    from differt_tpu.em import Material, MaterialsDict

    mats = MaterialsDict([
        Material(
            name="Concrete",
            properties=lambda f: (jnp.asarray(5.24), jnp.asarray(0.1)),
        )
    ])
    dm = deepmimo.export(
        paths=paths.reshape(1, -1, a.shape[-1]),
        scene=canyon,
        radio_materials=mats,
        frequency=FREQUENCY,
    )
    power_dm = np.asarray(10 ** (dm.power / 10.0))
    mask = np.asarray(dm.mask)
    np.testing.assert_allclose(
        power_cov[mask], power_dm[mask], rtol=1e-4
    )


def test_gradients_to_tx_position(canyon: Scene) -> None:
    import differt_tpu.treekit as tk

    eta_r = jnp.array([5.24])
    sigma = jnp.array([0.1])

    def total_power(tx):
        scene = tk.tree_at(lambda s: s.transmitters, canyon, tx)
        paths = scene.trace_paths(order=1)
        return received_power(
            paths, scene, FREQUENCY, eta_r=eta_r, conductivity=sigma
        ).sum()

    g = jax.grad(total_power)(jnp.array([-20.0, 0.0, 5.0]))
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


@pytest.mark.slow
def test_power_map_with_diffraction() -> None:
    # Occluded receiver: diffraction fills the shadow that pure reflection
    # paths leave empty.
    mesh = Mesh.box(2.0, 6.0, 2.0, with_top=True).set_materials("Metal")
    scene = Scene(
        transmitters=jnp.array([-10.0, 0.0, 5.0]),
        receivers=jnp.array([[10.0, 0.0, -4.0]]),
        mesh=mesh,
    )
    without = power_map(scene, FREQUENCY, order=1)
    with_d = power_map(scene, FREQUENCY, order=1, with_diffraction=True)
    assert float(with_d.reshape(())) > float(without.reshape(()))


class TestTxPattern:
    """TX radiation patterns in the coverage pipeline (extends reference)."""

    def _free_space(self):
        from differt_tpu.geometry import Mesh, Scene

        far = Mesh.plane(
            jnp.array([0.0, 0.0, -500.0]),
            normal=jnp.array([0.0, 0.0, 1.0]),
            side_length=1.0,
        )
        r = 100.0
        inv_sqrt2 = 1.0 / np.sqrt(2.0)
        return Scene(
            transmitters=jnp.array([[0.0, 0.0, 0.0]]),
            receivers=jnp.array(
                [
                    [r, 0.0, 0.0],  # horizon (theta = 90 deg)
                    [0.0, 0.0, r],  # along the dipole axis
                    [r * inv_sqrt2, 0.0, r * inv_sqrt2],  # 45 deg
                ]
            ),
            mesh=far,
        )

    def test_short_dipole_gain_shape(self) -> None:
        from differt_tpu.coverage import received_power
        from differt_tpu.em._antenna import ShortDipolePattern

        scene = self._free_space()
        paths = scene.trace_paths(order=0)
        eta, sig = jnp.array([1.0]), jnp.array([0.0])
        p_iso = received_power(paths, scene, 2.4e9, eta_r=eta, conductivity=sig)
        pattern = ShortDipolePattern(
            frequency=2.4e9,
            center=jnp.zeros(3),
            direction=jnp.array([0.0, 0.0, 1.0]),
        )
        p_dip = received_power(
            paths, scene, 2.4e9, eta_r=eta, conductivity=sig, tx_pattern=pattern
        )
        ratio = np.asarray(p_dip / p_iso).ravel()
        # Short dipole: G(theta) = 1.5 sin^2(theta).
        np.testing.assert_allclose(ratio, [1.5, 0.0, 0.75], atol=1e-3)

    def test_half_wave_dipole_peak_gain(self) -> None:
        from differt_tpu.coverage import received_power
        from differt_tpu.em._antenna import HWDipolePattern

        scene = self._free_space()
        paths = scene.trace_paths(order=0)
        eta, sig = jnp.array([1.0]), jnp.array([0.0])
        p_iso = received_power(paths, scene, 2.4e9, eta_r=eta, conductivity=sig)
        pattern = HWDipolePattern(
            frequency=2.4e9,
            center=jnp.zeros(3),
            direction=jnp.array([0.0, 0.0, 1.0]),
        )
        p_hw = received_power(
            paths, scene, 2.4e9, eta_r=eta, conductivity=sig, tx_pattern=pattern
        )
        np.testing.assert_allclose(
            float((p_hw / p_iso)[0, 0]), 1.640922, rtol=1e-4
        )


class TestPowerMapChunked:
    """Streaming power map == dense power map, for any tile sizes."""

    @pytest.mark.parametrize("coherent", [True, False])
    @pytest.mark.parametrize("candidate_chunk,rx_chunk", [(7, 3), (4096, 4096)])
    def test_matches_dense(self, coherent, candidate_chunk, rx_chunk):
        from differt_tpu.coverage import power_map, power_map_chunked
        from differt_tpu.scenes import street_canyon_scene
        import differt_tpu.treekit as tk

        scene = street_canyon_scene(with_ground=True)
        scene = tk.tree_at(
            lambda s: (s.transmitters, s.receivers),
            scene,
            (
                jnp.array([[-30.0, 0.0, 5.0]]),
                jnp.stack(
                    jnp.meshgrid(
                        jnp.linspace(-20.0, 20.0, 5),
                        jnp.linspace(-6.0, 6.0, 4),
                    )
                    + [jnp.full((4, 5), 1.5)],
                    axis=-1,
                ),
            ),
        )
        dense = power_map(scene, 2.4e9, order=1, coherent=coherent)
        chunked = power_map_chunked(
            scene,
            2.4e9,
            order=1,
            coherent=coherent,
            candidate_chunk=candidate_chunk,
            rx_chunk=rx_chunk,
        )
        assert chunked.shape == dense.shape
        chex.assert_trees_all_close(chunked, dense, rtol=1e-5, atol=1e-24)

    def test_pruned_candidates_input(self):
        from differt_tpu.coverage import power_map_chunked
        from differt_tpu.geometry import generate_all_path_candidates
        from differt_tpu.scenes import street_canyon_scene
        import differt_tpu.treekit as tk
        import numpy as np

        scene = street_canyon_scene(with_ground=True)
        scene = tk.tree_at(
            lambda s: (s.transmitters, s.receivers),
            scene,
            (jnp.array([[-30.0, 0.0, 5.0]]), jnp.array([[20.0, 3.0, 1.5]])),
        )
        cands = np.asarray(
            generate_all_path_candidates(scene.mesh.num_triangles, 2)
        )[::3]
        out = power_map_chunked(
            scene, 2.4e9, path_candidates=cands, candidate_chunk=64
        )
        assert out.shape == (1, 1)
        assert np.isfinite(np.asarray(out)).all()


def test_undersized_material_table_clamps_not_nan() -> None:
    """A material table shorter than the mesh's material count must clamp
    (documented) rather than NaN-fill via JAX's out-of-bounds gather — one
    NaN amplitude poisons the whole coherent pixel sum (found on bruxelles,
    whose CONCRETE ground is material index 1)."""
    import differt_tpu.treekit as tk
    from differt_tpu.coverage import power_map
    from differt_tpu.geometry import Mesh, Scene

    wall = Mesh.plane(
        jnp.array([0.0, 2.0, 1.0]),
        normal=jnp.array([0.0, -1.0, 0.0]),
        side_length=8.0,
    ).set_materials("itu_brick")
    ground = Mesh.plane(
        jnp.array([0.0, 0.0, 0.0]),
        normal=jnp.array([0.0, 0.0, 1.0]),
        side_length=8.0,
    ).set_materials("itu_concrete")
    mesh = wall + ground
    assert len(mesh.material_names) == 2
    scene = Scene(
        transmitters=jnp.array([[-2.0, 0.0, 1.0]]),
        receivers=jnp.array([[2.0, 0.0, 1.0]]),
        mesh=mesh,
    )
    # Table of length 1 for a 2-material mesh: ground bounces clamp to
    # entry 0 instead of gathering NaN.
    out = power_map(
        scene,
        2.4e9,
        order=1,
        eta_r=jnp.array([5.24]),
        conductivity=jnp.array([0.12]),
    )
    assert bool(jnp.all(jnp.isfinite(out)))
    assert bool(jnp.any(out > 0.0))



def test_sp_frame_gradient_finite_at_normal_incidence() -> None:
    # At normal incidence the plane of incidence is undefined (a zero cross
    # product), which masked-out dummy paths hit against walls facing them.
    # The gradient through that frame must stay finite: a nan there poisons
    # the whole coherent sum of a coverage tile's TX gradient.
    from differt_tpu.utils import sp_directions3

    def frame_sum(x):
        k = (x, 0.0 * x, 0.0 * x)
        (e_i_s, e_i_p), (_, e_r_p) = sp_directions3(k, k, (1.0, 0.0, 0.0))
        return sum(e_i_s) + sum(e_i_p) + sum(e_r_p)

    assert bool(jnp.isfinite(jax.grad(frame_sum)(1.0)))
