"""Texture-LOD mode (``PathTracer(texture_lod=...)``).

Bounces at depth >= ``texture_lod_depth`` sample a small mip atlas instead
of the ~70 MB full-res one, shrinking the HBM-miss-bound share of the
per-bounce gather to the screen-coherent shallow lanes
(``ops/texture.resolve_base_color_lod``).

Equivalence claim under test: with ``texture_lod == texture_budget`` the mip
IS the atlas, so every lane fetches the same texel value regardless of its
LOD classification — the render must be **bit-identical** to the exact path
(unlike deferred-texture mode, no re-factored arithmetic is involved).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import path_tracing__ray_tracer_tpu as ptrt
from path_tracing__ray_tracer_tpu.models.path_tracer import _path_chunk


def _chunk_img(cs, cam12, **kw):
    out = _path_chunk(cs, cam12, jnp.int32(0), jnp.uint32(7), jnp.int32(0), **kw)
    return np.stack([np.asarray(out.x), np.asarray(out.y), np.asarray(out.z)], -1)


@pytest.fixture(scope="module")
def cornell_pair():
    builder = ptrt.CustomSceneBuilder()
    scene = builder.build_scene()
    cam12 = ptrt.pack_camera(builder.create_camera(4.0 / 3.0))
    exact = ptrt.compile_scene(scene, texture_budget=64)
    lod = ptrt.compile_scene(scene, texture_budget=64, mip_budget=64)
    return exact, lod, cam12


def test_lod_bit_identical_when_mip_is_atlas(cornell_pair):
    exact, lod, cam12 = cornell_pair
    kw = dict(n_pix=1024, width=32, height=32, n_samples=4, max_depth=5,
              jitter="independent")
    want = _chunk_img(exact, cam12, **kw)
    got = _chunk_img(lod, cam12, lod_depth=2, **kw)
    np.testing.assert_array_equal(got, want)


def test_lod_small_mip_close(cornell_pair):
    """A genuinely minified mip only perturbs deep-bounce texture detail."""
    exact, _, cam12 = cornell_pair
    builder = ptrt.CustomSceneBuilder()
    small = ptrt.compile_scene(builder.build_scene(), texture_budget=64,
                               mip_budget=16)
    kw = dict(n_pix=1024, width=32, height=32, n_samples=4, max_depth=5,
              jitter="independent")
    want = _chunk_img(exact, cam12, **kw)
    got = _chunk_img(small, cam12, lod_depth=2, **kw)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).mean()) < 0.05 * max(want.mean(), 1e-6)


def test_lod_renderer_option(cornell_pair):
    """Factory-level plumbing: texture_lod compiles a mip and renders; with a
    full-res-equivalent budget the image equals the exact renderer's."""
    builder = ptrt.CustomSceneBuilder()
    scene = builder.build_scene()
    cam = builder.create_camera(4.0 / 3.0)
    s = ptrt.RenderSettings(width=32, height=24, samples_per_pixel=2, max_depth=3)
    exact = ptrt.RendererFactory.create("tpu_path_raytracer", seed=9)
    lod = ptrt.RendererFactory.create(
        "tpu_path_raytracer", seed=9, texture_lod=1 << 14
    )
    a = np.asarray(exact.render(scene, cam, s))
    b = np.asarray(lod.render(scene, cam, s))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError):
        ptrt.RendererFactory.create(
            "tpu_path_raytracer", mip_budget=32, texture_lod=32
        )
