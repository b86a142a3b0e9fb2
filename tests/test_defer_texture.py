"""Deferred-texture mode (``compile_scene(mip_budget=...)``).

Deferred mode runs the exact atlas gather once per *path* instead of once
per *bounce*: the camera bounce records its exact texel index, secondary
bounces sample a small mip atlas, and one bulk gather resolves every path's
camera base color at the chunk fold
(``models/path_tracer._regen_chunk``).

Equivalence claim under test: with ``mip_budget == texture_budget`` the mip
IS the atlas, so deferred rendering must reproduce the exact path up to FMA
reassociation (the factored ``A + base0*B`` accumulation rounds differently,
which can flip borderline RR/cutoff decisions on rare lanes — same two-regime
tolerance as tests/test_regen.py).
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
def cornell_pair(request):
    """(exact_cs, defer_cs) with mip == atlas (budget 64 keeps CPU fast)."""
    builder = ptrt.CustomSceneBuilder()
    scene = builder.build_scene()
    cam12 = ptrt.pack_camera(builder.create_camera(4.0 / 3.0))
    exact = ptrt.compile_scene(scene, texture_budget=64)
    defer = ptrt.compile_scene(scene, texture_budget=64, mip_budget=64)
    return exact, defer, cam12


def test_mip_fields_compiled(cornell_pair):
    exact, defer, _ = cornell_pair
    assert exact.mip_atlas is None
    assert defer.mip_atlas is not None
    # mip_budget == texture_budget → identical tables
    np.testing.assert_array_equal(np.asarray(defer.mip_atlas),
                                  np.asarray(defer.atlas))
    np.testing.assert_array_equal(np.asarray(defer.mip_offset),
                                  np.asarray(defer.tex_offset))
    assert int(defer.mip_atlas.shape[0]) == int(defer.atlas.shape[0])


def test_defer_matches_exact_when_mip_is_atlas(cornell_pair):
    exact, defer, cam12 = cornell_pair
    kw = dict(n_pix=1024, width=32, height=32, n_samples=4, max_depth=5,
              jitter="independent")
    want = _chunk_img(exact, cam12, **kw)
    got = _chunk_img(defer, cam12, **kw)
    diff = np.abs(got - want)
    # two-regime assertion (test_regen.py): FMA-reassociation flips touch
    # isolated lanes; a deferral bug (wrong coefficient split, lost texel id,
    # wrong channel) moves whole-sample magnitudes on many pixels
    assert float(np.mean(diff > 1e-3)) < 0.01, (
        f"{(diff > 1e-3).mean():.4f} of elements differ by >1e-3 "
        f"(max {diff.max():.4f}) — deferral bug, not float flips"
    )
    assert float(diff.mean()) < 1e-3


def test_defer_small_mip_close(cornell_pair):
    """A genuinely minified mip (16 px) only perturbs secondary-bounce texture
    detail — the image must stay close to exact, not merely finite."""
    exact, _, cam12 = cornell_pair
    builder = ptrt.CustomSceneBuilder()
    small = ptrt.compile_scene(builder.build_scene(), texture_budget=64,
                               mip_budget=16)
    kw = dict(n_pix=1024, width=32, height=32, n_samples=4, max_depth=5,
              jitter="independent")
    want = _chunk_img(exact, cam12, **kw)
    got = _chunk_img(small, cam12, **kw)
    assert np.isfinite(got).all()
    # secondary-bounce-only perturbation: small mean shift, correlated images
    assert float(np.abs(got - want).mean()) < 0.05 * max(want.mean(), 1e-6)
