"""The XLA BVH walk (``ops/bvh.py``) against the broadcast brute force, and
``scene_hit``/``scene_hit_any`` route choice.

The walk is the only traversal mesh scenes have, so it is held to the
brute-force answer at every leaf size the builder takes, for closest and
any-hit queries, unbounded and per-ray bounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import path_tracing__ray_tracer_tpu as ptrt
from path_tracing__ray_tracer_tpu.compiler import compile_scene
from path_tracing__ray_tracer_tpu.ops import bvh as bvh_mod
from path_tracing__ray_tracer_tpu.ops import intersect
from path_tracing__ray_tracer_tpu.ops.v3 import V3

N_TRIS = 300


def _soup(seed, n=N_TRIS, textured=None):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v1 = base + rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    uvs = rng.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    scene = ptrt.Scene()
    for i in range(n):
        mat = ptrt.Material(ptrt.Vec3(*rng.uniform(0.2, 1.0, 3)),
                            diffuse=0.8, texture=textured)
        kw = {}
        if textured is not None:
            kw = dict(uv0=uvs[i, 0], uv1=uvs[i, 1], uv2=uvs[i, 2])
        scene.add_object(ptrt.Triangle(ptrt.Vec3(*base[i]), ptrt.Vec3(*v1[i]),
                                       ptrt.Vec3(*v2[i]), material=mat, **kw))
    scene.add_light_sample(ptrt.Vec3(0, 15, 0))
    return scene


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return V3.from_array(ro), V3.from_array(rd)


@pytest.fixture(scope="module")
def soup_pair():
    """The same triangle soup compiled without a BVH (broadcast route) and
    the tri-min/max boxes to build trees from."""
    scene = _soup(21)
    flat = compile_scene(scene, with_textures=False, merge_quads=False,
                         use_bvh=False)
    v = [np.stack([np.asarray(c) for c in p], -1)
         for p in (flat.triangles.v0, flat.triangles.v1, flat.triangles.v2)]
    lo = np.minimum(np.minimum(v[0], v[1]), v[2])
    hi = np.maximum(np.maximum(v[0], v[1]), v[2])
    return flat, lo, hi


def _with_tree(flat, lo, hi, leaf_size):
    arrs = bvh_mod.build_bvh(lo, hi, leaf_size=leaf_size, use_native=False)
    assert arrs["slots"].shape[1] == leaf_size
    return flat._replace(bvh=bvh_mod.to_device(arrs))


def _bound(kind, n):
    if kind == "unbounded":
        return 1e6
    return jnp.asarray(np.random.default_rng(5).uniform(2.0, 25.0, n),
                       jnp.float32)


@pytest.mark.parametrize("bound", ["unbounded", "bounded"])
@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("leaf_size", [4, 8, 16])
def test_walk_matches_bruteforce(soup_pair, leaf_size, query, bound):
    flat, lo, hi = soup_pair
    tree = _with_tree(flat, lo, hi, leaf_size)
    n = 512
    ro, rd = _rays(n, 40 + leaf_size)
    t_max = _bound(bound, n)
    if query == "closest":
        want = intersect.scene_hit(flat, ro, rd, 1e-3, t_max)
        got = intersect.scene_hit(tree, ro, rd, 1e-3, t_max)
        hit = np.asarray(want.hit)
        assert hit.any() and not hit.all()
        np.testing.assert_array_equal(np.asarray(got.hit), hit)
        np.testing.assert_array_equal(np.asarray(got.prim)[hit],
                                      np.asarray(want.prim)[hit])
        np.testing.assert_allclose(np.asarray(got.t)[hit],
                                   np.asarray(want.t)[hit], rtol=1e-5)
    else:
        want = np.asarray(intersect.scene_hit_any(flat, ro, rd, 1e-3, t_max))
        got = np.asarray(intersect.scene_hit_any(tree, ro, rd, 1e-3, t_max))
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got, want)


def test_any_walk_parks_dont_care_lanes(soup_pair):
    """``limit = -1`` marks lanes whose occlusion answer is unused (the path
    tracer's NEE for misses and back-facing lights): they report no hit and
    leave the other lanes' answers unchanged."""
    flat, lo, hi = soup_pair
    tree = _with_tree(flat, lo, hi, bvh_mod.LEAF_SIZE)
    n = 256
    ro, rd = _rays(n, 3)
    care = np.arange(n) % 2 == 0
    limit = jnp.where(jnp.asarray(care), 1e6, -1.0).astype(jnp.float32)
    got = np.asarray(bvh_mod.traverse_any(tree.bvh, tree.triangles, ro, rd,
                                          1e-3, limit))
    want = np.asarray(intersect.scene_hit_any(flat, ro, rd, 1e-3, 1e6))
    assert not got[~care].any()
    np.testing.assert_array_equal(got[care], want[care])


def test_textured_triangle_uv_through_bvh():
    """Barycentric UV interpolation of textured triangles is the same on
    the BVH route as on the broadcast route."""
    from path_tracing__ray_tracer_tpu.utils.assets import texture_path

    tex = ptrt.Texture(texture_path("red.jpg"))
    scene = _soup(8, n=280, textured=tex)
    flat = compile_scene(scene, merge_quads=False, use_bvh=False)
    tree = compile_scene(scene, merge_quads=False, use_bvh=True)
    assert tree.bvh is not None and flat.bvh is None
    assert tree.tri_uv_used.shape[0] == 1
    ro, rd = _rays(512, 9)
    a = intersect.scene_hit(flat, ro, rd, 1e-3, 1e6)
    b = intersect.scene_hit(tree, ro, rd, 1e-3, 1e6)
    hit = np.asarray(a.hit)
    assert hit.sum() > 20
    np.testing.assert_array_equal(np.asarray(b.prim)[hit], np.asarray(a.prim)[hit])
    for x, y in ((a.u, b.u), (a.v, b.v)):
        x, y = np.asarray(x)[hit], np.asarray(y)[hit]
        assert np.ptp(x) > 0.1  # real interpolated coordinates, not zeros
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6)


ROUTES = ["broadcast", "bvh", "sequential"]


@pytest.fixture(scope="module")
def mixed_scene():
    """Planes, spheres, quads and a few hundred triangles: every route has
    something of each type to get right."""
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
        MeshSceneBuilder,
    )

    return MeshSceneBuilder(grid=2, subdivisions=1).build_scene()


def _route_scene(scene, route, monkeypatch):
    if route == "bvh":
        cs = compile_scene(scene, with_textures=False, use_bvh=True)
        assert cs.bvh is not None
        return cs
    cs = compile_scene(scene, with_textures=False, use_bvh=False)
    assert cs.bvh is None
    if route == "sequential":
        monkeypatch.setattr(intersect, "BROADCAST_LIMIT", 0)
    return cs


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_broadcast(mixed_scene, route, query, monkeypatch):
    ref = compile_scene(mixed_scene, with_textures=False, use_bvh=False)
    n = 512
    rng = np.random.default_rng(17)
    ro = V3.from_array(rng.uniform(-12, 12, (n, 3)).astype(np.float32)
                       + np.array([0, 14, 0], np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    rd = V3.from_array(d / np.linalg.norm(d, axis=-1, keepdims=True))
    if query == "closest":
        want = intersect.scene_hit(ref, ro, rd, 1e-3, 1e6)
    else:
        want = intersect.scene_hit_any(ref, ro, rd, 1e-3, 25.0)
    cs = _route_scene(mixed_scene, route, monkeypatch)
    if query == "closest":
        got = intersect.scene_hit(cs, ro, rd, 1e-3, 1e6)
        hit = np.asarray(want.hit)
        assert hit.mean() > 0.5
        np.testing.assert_array_equal(np.asarray(got.hit), hit)
        np.testing.assert_array_equal(np.asarray(got.prim)[hit],
                                      np.asarray(want.prim)[hit])
        np.testing.assert_allclose(np.asarray(got.t)[hit],
                                   np.asarray(want.t)[hit], rtol=1e-5)
        np.testing.assert_allclose(np.asarray(got.normal.to_array())[hit],
                                   np.asarray(want.normal.to_array())[hit],
                                   atol=1e-5)
    else:
        got = intersect.scene_hit_any(cs, ro, rd, 1e-3, 25.0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("renderer", ["tpu_path_raytracer", "tpu_texture_raytracer"])
def test_bvh_render_matches_flat_render(renderer):
    """A tiny mesh rendered through the BVH walk and through the broadcast
    sweep: the same image (a tie between exactly equal hits may resolve
    differently, so a handful of pixels may differ)."""
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
        MeshSceneBuilder,
    )

    b = MeshSceneBuilder(grid=1, subdivisions=1)
    scene, cam = b.build_scene(), b.create_camera(4 / 3)
    s = ptrt.RenderSettings(width=32, height=24, samples_per_pixel=4, max_depth=3)
    imgs = []
    for use_bvh in (True, False):
        r = ptrt.RendererFactory.create(
            renderer, seed=2, compile_overrides={"use_bvh": use_bvh})
        assert (r.compiled(scene).bvh is not None) == use_bvh
        imgs.append(np.asarray(r.render(scene, cam, s)).astype(np.int32))
    diff = np.abs(imgs[0] - imgs[1])
    assert imgs[1].mean() > 5.0
    assert np.mean(diff > 1) < 0.01, np.mean(diff > 1)
