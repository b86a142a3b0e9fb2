"""Ray-regeneration equivalence: the regenerating chunk scheduler
(``models/path_tracer._regen_chunk``) must reproduce the straightforward
per-sample loop over ``path_radiance`` — same RNG streams, same per-item
(sample, depth) accumulation order, only lane scheduling differs.

Tolerance note: the two schedulers compile *different loop bodies*, and XLA's
instruction selection (FMA/vectorization) inside a ``while_loop`` body is not
identical across formulations.  The resulting ≤few-ulp differences in carried
throughput occasionally flip a borderline binary decision (throughput cutoff,
Russian-roulette survival), after which that single path diverges — measured
~0.1% of pixels shifted by up to ~0.2 at depth 8.  A *scheduling* bug
(dropped, duplicated or misbinned work item) moves whole-sample magnitudes on
a large pixel fraction, so the assertions below separate the two regimes:
tight mean error, tiny fraction of flip-scale outliers.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import path_tracing__ray_tracer_tpu as ptrt
from path_tracing__ray_tracer_tpu.models.path_tracer import (
    _path_chunk,
    path_radiance,
)
from path_tracing__ray_tracer_tpu.models.wavefront import pixel_coords
from path_tracing__ray_tracer_tpu.ops import rng
from path_tracing__ray_tracer_tpu.ops.camera import generate_rays


def _reference_sums(cs, cam12, pix0, seed, sample_base, n_pix, width, height,
                    n_samples, max_depth, jitter):
    """The pre-regeneration scheduler: plain loop over samples."""
    idx, x, y = pixel_coords(pix0, n_pix, width, height)
    acc = None
    for s in range(n_samples):
        key = rng.ray_key(seed, idx, sample_base + s)
        if jitter == "center":
            r1 = r2 = jnp.float32(0.5)
        else:
            r1 = rng.uniform(key, max_depth, 0)
            r2 = r1 if jitter == "diagonal" else rng.uniform(key, max_depth, 1)
        o, d = generate_rays(cam12, (x + r1) / width, (y + r2) / height)
        c = path_radiance(cs, o, d, key, max_depth)
        acc = c if acc is None else acc + c
    return np.stack([np.asarray(acc.x), np.asarray(acc.y), np.asarray(acc.z)], -1)


def _assert_schedulers_agree(got, want):
    diff = np.abs(got - want)
    # ulp-flip regime: rare isolated outliers; scheduling bugs move whole
    # samples (0.05–20 radiance) on a large fraction of pixels
    assert float(np.mean(diff > 1e-3)) < 0.01, (
        f"{(diff > 1e-3).mean():.4f} of elements differ by >1e-3 "
        f"(max {diff.max():.4f}) — scheduling bug, not float flips"
    )
    assert float(diff.mean()) < 1e-3, f"mean diff {diff.mean():.2e}"


@pytest.mark.parametrize("n_samples,max_depth", [(1, 4), (5, 8), (8, 3)])
def test_regen_matches_per_sample_loop(cornell, n_samples, max_depth):
    scene, cam = cornell
    cs = ptrt.compile_scene(scene)
    cam12 = ptrt.pack_camera(cam)
    n_pix, w, h = 2048, 64, 48

    got = _path_chunk(
        cs, cam12, jnp.int32(0), jnp.uint32(3), jnp.int32(0),
        n_pix=n_pix, width=w, height=h, n_samples=n_samples,
        max_depth=max_depth, jitter="independent",
    )
    got = np.stack([np.asarray(got.x), np.asarray(got.y), np.asarray(got.z)], -1)
    want = _reference_sums(cs, cam12, jnp.int32(0), jnp.uint32(3), jnp.int32(0),
                           n_pix, w, h, n_samples, max_depth, "independent")
    _assert_schedulers_agree(got, want)


def test_regen_nonzero_sample_base_and_pix0(cornell):
    """Progressive batches start mid-stream; regeneration must respect both
    offsets."""
    scene, cam = cornell
    cs = ptrt.compile_scene(scene)
    cam12 = ptrt.pack_camera(cam)
    n_pix, w, h = 1024, 40, 30

    got = _path_chunk(
        cs, cam12, jnp.int32(176), jnp.uint32(9), jnp.int32(6),
        n_pix=n_pix, width=w, height=h, n_samples=4, max_depth=5,
        jitter="diagonal",
    )
    got = np.stack([np.asarray(got.x), np.asarray(got.y), np.asarray(got.z)], -1)
    want = _reference_sums(cs, cam12, jnp.int32(176), jnp.uint32(9),
                           jnp.int32(6), n_pix, w, h, 4, 5, "diagonal")
    _assert_schedulers_agree(got, want)


def test_regen_deterministic(cornell):
    """Same (seed, settings) → identical sums, run to run."""
    scene, cam = cornell
    cs = ptrt.compile_scene(scene)
    cam12 = ptrt.pack_camera(cam)
    args = (cs, cam12, jnp.int32(0), jnp.uint32(11), jnp.int32(0))
    kw = dict(n_pix=1024, width=32, height=32, n_samples=6, max_depth=6,
              jitter="independent")
    a = _path_chunk(*args, **kw)
    b = _path_chunk(*args, **kw)
    np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
    np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))


def test_experimental_standard_mode_matches_production(cornell):
    """Drift guard for the scheduler fork: ``models/experimental
    .regen_chunk_modes`` is a copy of the multi-mode scheduler, and
    production ``_regen_chunk`` delegates to it only when a texture mode is
    requested — so nothing else would
    catch the forks drifting apart.  In standard mode (``lod_depth=0``, no
    mip atlas) the two must run the *same* computation:
    exact equality, not the flip tolerance."""
    import jax

    from path_tracing__ray_tracer_tpu.models.experimental import (
        regen_chunk_modes,
    )
    from path_tracing__ray_tracer_tpu.models.path_tracer import _regen_chunk

    scene, cam = cornell
    cs = ptrt.compile_scene(scene)
    assert cs.mip_atlas is None  # else production would delegate
    cam12 = ptrt.pack_camera(cam)
    kw = dict(n_pix=1024, width=40, height=30, n_samples=4, max_depth=5,
              jitter="independent")
    static = tuple(kw.keys()) + ("lod_depth",)
    args = (cs, cam12, jnp.int32(64), jnp.uint32(7), jnp.int32(2))

    prod = jax.jit(_regen_chunk, static_argnames=static)(
        *args, **kw)
    exp = jax.jit(regen_chunk_modes, static_argnames=static)(
        *args, **kw, lod_depth=0)
    for a, b, ch in zip((prod.x, prod.y, prod.z), (exp.x, exp.y, exp.z),
                        "xyz"):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"experimental standard mode drifted from production "
                    f"scheduler (channel {ch})")
