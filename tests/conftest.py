"""Test configuration: force the CPU backend with an 8-device virtual mesh.

The override goes through ``jax.config`` before any backend initialization,
so the tests run on the CPU even where a GPU is the default.  Tests of code
that runs only on a GPU carry the ``gpu`` marker and skip here; they run on
the card through ``python chip_smoke.py``.
"""
import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(scope="session")
def cornell():
    """Compiled-once Cornell scene + camera (shared across tests)."""
    import path_tracing__ray_tracer_tpu as ptrt

    builder = ptrt.CustomSceneBuilder()
    scene = builder.build_scene()
    camera = builder.create_camera(4.0 / 3.0)
    return scene, camera


@pytest.fixture(scope="session")
def tiny_scene():
    """A small hand-built scene with one primitive of each type."""
    import path_tracing__ray_tracer_tpu as ptrt
    from path_tracing__ray_tracer_tpu import Material, Plane, Sphere, Triangle, Vec3

    scene = ptrt.Scene()
    scene.add_object(
        Plane(
            Vec3(-10, -2, 10), Vec3(0, 1, 0), Vec3(20, 0, 0), Vec3(0, 0, -20),
            20.0, 20.0, Material(Vec3(0.2, 0.9, 0.3), diffuse=0.8, specular=0.1),
        )
    )
    scene.add_object(
        Sphere(Vec3(0, 0, -5), 1.0, Material(Vec3(0.9, 0.1, 0.1), diffuse=0.7,
                                             specular=0.4, reflective=0.2))
    )
    scene.add_object(
        Sphere(Vec3(2.5, 0, -5), 1.0, Material(Vec3(0.95, 0.95, 0.95), diffuse=0.1,
                                               specular=0.9, reflective=0.1,
                                               refractive=0.85, ior=1.5))
    )
    scene.add_object(
        Triangle(Vec3(-2, -1, -3), Vec3(-0.5, -1, -3), Vec3(-1.2, 0.5, -3.5),
                 material=Material(Vec3(0.1, 0.2, 0.9), diffuse=0.9))
    )
    scene.add_light_sample(Vec3(0, 8, 0))
    scene.add_light_sample(Vec3(1, 8, 1))
    return scene
