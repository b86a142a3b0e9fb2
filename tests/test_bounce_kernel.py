"""The fused bounce kernel (``ops/pallas/bounce_triton.py``) against the XLA
bounce, through the Pallas interpreter on the CPU.

Both run the same formulas; hit and Russian-roulette decisions must agree
on ≥ 99.99% of lanes, as on the card.  The float tolerance here is looser
than the card's (``chip_smoke.FIELD_RTOL``): on the CPU the interpreter's
sequential sweep and XLA's broadcast sweep contract multiply-adds
differently, and a glancing sphere hit solves an ill-conditioned quadratic
(``b² − ac`` cancels), so one rounding difference moves its hit point by up
to ~1e-4 relative — and with it the normal, cos θ in ``w_nee`` and the
scattered ray.  A wrong light, material or branch moves them by O(1).
The compiled kernel itself runs only on a GPU:
``test_compiled_kernel_on_gpu`` carries the ``gpu`` marker and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
import path_tracing__ray_tracer_tpu as ptrt
from path_tracing__ray_tracer_tpu.compiler import compile_scene
from path_tracing__ray_tracer_tpu.models.path_tracer import _bounce_xla, path_radiance
from path_tracing__ray_tracer_tpu.ops import rng
from path_tracing__ray_tracer_tpu.ops.camera import generate_rays
from path_tracing__ray_tracer_tpu.ops.pallas import bounce_triton
from path_tracing__ray_tracer_tpu.ops.v3 import V3


CPU_RTOL = CPU_ATOL = 1e-3


def _agree(got, want, rtol=CPU_RTOL, atol=CPU_ATOL):
    stats = chip_smoke.compare_bounce(got, want, rtol=rtol, atol=atol)
    assert chip_smoke.bounce_ok(stats), stats


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(bounce_triton, "INTERPRET", True)


def _state(cs, cam12, n, seed, depth):
    """Render state as the driver sees it: camera rays through random
    pixels at depth 0, the rays one XLA bounce later otherwise."""
    r = np.random.default_rng(seed)
    u, v = (jnp.asarray(r.uniform(0, 1, n), jnp.float32) for _ in range(2))
    o, d = generate_rays(cam12, u, v)
    key = rng.ray_key(jnp.uint32(seed), jnp.arange(n), 0)
    thr = V3.from_array(r.uniform(0.05, 1.0, (n, 3)).astype(np.float32))
    if depth:
        first = _bounce_xla(cs, o, d, thr, key, 0)
        o, d = first.new_org, first.new_dir
    return o, d, thr, key


@pytest.fixture(scope="module")
def compiled(cornell, tiny_scene):
    cam = ptrt.CustomSceneBuilder().create_camera(4 / 3)
    tiny_cam = ptrt.Camera(ptrt.Vec3(0, 1, 2), ptrt.Vec3(1, 0, -5),
                           ptrt.Vec3(0, 1, 0), 60.0, 4 / 3)
    return {"cornell": (compile_scene(cornell[0]), ptrt.pack_camera(cam)),
            "tiny_scene": (compile_scene(tiny_scene), ptrt.pack_camera(tiny_cam))}


@pytest.mark.parametrize("depth", [0, 3])
@pytest.mark.parametrize("shadow_tmax", ["reference", "light"])
@pytest.mark.parametrize("scene", ["cornell", "tiny_scene"])
def test_kernel_matches_xla_bounce(compiled, scene, shadow_tmax, depth, interpret):
    cs, cam12 = compiled[scene]
    o, d, thr, key = _state(cs, cam12, 512, 3 + depth, depth)
    got = bounce_triton.path_bounce(cs, o, d, thr, key, depth,
                                    shadow_tmax=shadow_tmax)
    want = _bounce_xla(cs, o, d, thr, key, depth, shadow_tmax=shadow_tmax)
    assert np.asarray(want.hit).sum() >= 10
    if depth >= 3:
        assert np.asarray(want.killed).any()  # Russian roulette exercised
    _agree(got, want)


@pytest.mark.parametrize("n", [1, 257, 700])
def test_kernel_pads_partial_blocks(compiled, n, interpret):
    """Lane counts that are not a multiple of the block: the wrapper pads
    and slices, and every real lane matches."""
    assert n % bounce_triton.BLOCK != 0
    cs, cam12 = compiled["cornell"]
    o, d, thr, key = _state(cs, cam12, n, n, 1)
    depth = jnp.asarray(np.arange(n) % 5, jnp.int32)  # per-lane depths
    got = bounce_triton.path_bounce(cs, o, d, thr, key, depth)
    want = _bounce_xla(cs, o, d, thr, key, depth)
    assert got.hit.shape == (n,) and got.new_dir.x.shape == (n,)
    _agree(got, want)


def test_kernel_path_radiance_matches_xla(compiled, interpret):
    """Whole paths through the kernel (``path_radiance`` picks it by the
    gate) against the XLA bounce."""
    cs, cam12 = compiled["cornell"]
    o, d, _thr, key = _state(cs, cam12, 256, 5, 0)
    got = path_radiance(cs, o, d, key, max_depth=4)
    want = path_radiance(cs, o, d, key, max_depth=4, kernel=False)
    np.testing.assert_allclose(np.asarray(got.to_array()),
                               np.asarray(want.to_array()), rtol=CPU_RTOL,
                               atol=CPU_ATOL)


def test_gate_on_cpu_without_interpret(compiled):
    """On the CPU the kernel is chosen only under an explicit INTERPRET."""
    assert not bounce_triton.use_kernel(compiled["cornell"][0])


def test_gate_with_interpret(compiled, interpret):
    assert bounce_triton.use_kernel(compiled["cornell"][0])
    assert bounce_triton.use_kernel(compiled["tiny_scene"][0])


def test_gate_declines_bvh_and_large_scenes(interpret, monkeypatch):
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
        MeshSceneBuilder,
    )

    scene = MeshSceneBuilder(grid=1, subdivisions=1).build_scene()
    assert not bounce_triton.use_kernel(compile_scene(scene, use_bvh=True))
    flat = compile_scene(scene, use_bvh=False)
    assert bounce_triton.use_kernel(flat)
    monkeypatch.setattr(bounce_triton, "BROADCAST_LIMIT", 10)
    assert not bounce_triton.use_kernel(flat)


def test_renderer_plans_xla_when_disabled(cornell, interpret, monkeypatch):
    """``ENABLED = False`` makes new renderers plan the XLA bounce: the
    image equals the kernel's up to the tolerance of the bounce record."""
    scene, cam = cornell
    s = ptrt.RenderSettings(width=16, height=16, samples_per_pixel=2, max_depth=3)
    kernel = ptrt.RendererFactory.create("tpu_path_raytracer", seed=4)
    a = kernel.render_array(scene, cam, s)
    monkeypatch.setattr(bounce_triton, "ENABLED", False)
    plain = ptrt.RendererFactory.create("tpu_path_raytracer", seed=4)
    b = plain.render_array(scene, cam, s)
    np.testing.assert_allclose(a, b, rtol=CPU_RTOL, atol=CPU_ATOL)


@pytest.mark.gpu
def test_compiled_kernel_on_gpu(compiled):
    """The compiled kernel against the XLA bounce; needs a GPU (the same
    check runs at full width in ``chip_smoke.py``'s bounce_kernel phase)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU form")
    cs, cam12 = compiled["cornell"]
    o, d, thr, key = _state(cs, cam12, 4096, 1, 0)
    got = bounce_triton.path_bounce(cs, o, d, thr, key, 0)
    want = _bounce_xla(cs, o, d, thr, key, 0)
    _agree(got, want, rtol=chip_smoke.FIELD_RTOL, atol=chip_smoke.FIELD_ATOL)
