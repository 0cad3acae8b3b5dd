"""Procedural benchmark scenes.

The BASELINE configs reference downloadable Sionna scenes (street canyon,
Munich); in network-less environments these deterministic procedural scenes
stand in at matching scales: a two-building street canyon and a
Manhattan-grid city of ~10k triangles.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Mesh, Scene


def street_canyon_scene(
    *,
    street_width: float = 20.0,
    building_height: float = 25.0,
    building_depth: float = 15.0,
    length: float = 100.0,
    with_ground: bool = True,
) -> Scene:
    """A street canyon: two building rows facing each other plus ground.

    Stands in for the Sionna ``simple_street_canyon`` scene.

    Examples:
        >>> from differt_tpu.scenes import street_canyon_scene
        >>> scene = street_canyon_scene()
        >>> int(scene.mesh.num_triangles) > 0
        True
        >>> scene.mesh.material_names
        ('Concrete',)
    """
    return _street_canyon_scene(
        street_width=street_width,
        building_height=building_height,
        building_depth=building_depth,
        length=length,
        with_ground=with_ground,
    )


def _street_canyon_scene(
    *,
    street_width: float,
    building_height: float,
    building_depth: float,
    length: float,
    with_ground: bool,
) -> Scene:
    half = street_width / 2.0
    left = (
        Mesh.box(length, building_depth, building_height, with_top=True)
        .translate(
            jnp.array([0.0, -(half + building_depth / 2.0), building_height / 2.0])
        )
    )
    right = (
        Mesh.box(length, building_depth, building_height, with_top=True)
        .translate(
            jnp.array([0.0, half + building_depth / 2.0, building_height / 2.0])
        )
    )
    mesh = left + right
    if with_ground:
        ground = Mesh.plane(
            jnp.zeros(3),
            normal=jnp.array([0.0, 0.0, 1.0]),
            side_length=2.0 * length,
        )
        mesh = mesh + ground
    return Scene(mesh=mesh.set_materials("Concrete"))


def urban_scene(
    num_blocks_x: int = 8,
    num_blocks_y: int = 8,
    **kwargs,
) -> Scene:
    """A Manhattan grid of buildings with random heights (~10k triangles).

    ``subdivisions`` splits each building into a stack of boxes so the
    triangle count reaches city-mesh scales (config 3 of BASELINE.md) while
    keeping a realistic skyline. Deterministic given ``key``.
    """
    return _urban_scene(num_blocks_x, num_blocks_y, **kwargs)


def _urban_scene(
    num_blocks_x: int = 8,
    num_blocks_y: int = 8,
    *,
    block_size: float = 50.0,
    street_width: float = 15.0,
    min_height: float = 10.0,
    max_height: float = 60.0,
    subdivisions: int = 3,
    with_ground: bool = True,
    key: jax.Array | None = None,
) -> Scene:
    if key is None:
        key = jax.random.key(0)

    heights = jax.random.uniform(
        key,
        (num_blocks_x, num_blocks_y),
        minval=min_height,
        maxval=max_height,
    )

    footprint = block_size - street_width
    extent_x = num_blocks_x * block_size
    extent_y = num_blocks_y * block_size

    # Instance a single unit-box template per building level with numpy:
    # chaining Mesh.append would compile one shape-unique device program
    # per building.
    template = Mesh.box(1.0, 1.0, 1.0, with_top=True)
    tmpl_v = np.asarray(template.vertices)
    tmpl_t = np.asarray(template.triangles)
    heights_np = np.asarray(heights)

    verts_list: list[np.ndarray] = []
    tris_list: list[np.ndarray] = []
    bounds: list[tuple[int, int]] = []
    v_offset = 0
    t_offset = 0
    for i in range(num_blocks_x):
        for j in range(num_blocks_y):
            h = float(heights_np[i, j])
            cx = (i + 0.5) * block_size - extent_x / 2.0
            cy = (j + 0.5) * block_size - extent_y / 2.0
            # A stack of shrinking boxes: more triangles + varied facades.
            z0 = 0.0
            for level in range(subdivisions):
                frac = 1.0 - 0.25 * level
                level_h = h / subdivisions
                scale = np.array(
                    [footprint * frac, footprint * frac, level_h]
                )
                center = np.array([cx, cy, z0 + level_h / 2.0])
                verts_list.append(tmpl_v * scale + center)
                tris_list.append(tmpl_t + v_offset)
                bounds.append((t_offset, t_offset + tmpl_t.shape[0]))
                v_offset += tmpl_v.shape[0]
                t_offset += tmpl_t.shape[0]
                z0 += level_h

    if with_ground:
        ground = Mesh.plane(
            jnp.zeros(3),
            normal=jnp.array([0.0, 0.0, 1.0]),
            side_length=2.0 * max(extent_x, extent_y),
        )
        verts_list.append(np.asarray(ground.vertices))
        tris_list.append(np.asarray(ground.triangles) + v_offset)
        bounds.append((t_offset, t_offset + ground.triangles.shape[0]))

    mesh = Mesh(
        vertices=jnp.asarray(np.concatenate(verts_list).astype(np.float32)),
        triangles=jnp.asarray(np.concatenate(tris_list).astype(np.int32)),
        object_bounds=jnp.asarray(np.array(bounds, dtype=np.int32)),
    )
    return Scene(mesh=mesh.set_materials("Concrete"))
