"""Smoke test of the renderer's main paths on one GPU, in one process.

Usage::

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # the four-card sharded render only

Exits non-zero, printing no result line, unless JAX's default device is a
GPU.  Every phase checks its own results; a failed check ends the run with a
traceback.  Each phase prints its compile seconds (first call, compile
included) and steady seconds (a repeat of the same shapes).  The last line
of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases:

1. Headline path trace: Cornell box, 1024x1024, depth 8, two 128-spp groups
   through ``RendererFactory`` — finite sums, a bit-identical same-seed
   rerun, and a quartered ``chunk_rays`` render that matches.
2. The fused bounce kernel (``ops/pallas/bounce_triton.py``) against the XLA
   bounce at 131,072 lanes of Cornell state, field by field, then the two
   full renders: their RMSE and their times.
3. Whitted at the upstream README's own setting through ``main.main``
   (2000x1500, 25 spp, depth 16), RMSE against the reference render.
4. The card against the host CPU backend of this same process.
5. Mesh scenes through the BVH walk via ``main.main``.
6. (``--four-cards`` only) the Cornell path trace sharded over four cards,
   against the one-card render.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

PHASES = ("path", "bounce_kernel", "whitted", "card_vs_cpu", "mesh")
FOUR_CARD_PHASES = ("four_cards",)

# ---- tolerances -------------------------------------------------------------
# The kernel and the XLA bounce run the same formulas; they differ only in
# FMA contraction and in the rounding of sqrt and division, so a last-bit
# difference can flip a Russian-roulette or hit test on a rare lane.
BRANCH_AGREE_MIN = 0.9999  # share of lanes whose hit/killed flags agree
FIELD_RTOL, FIELD_ATOL = 1e-5, 1e-6  # float fields, on the agreeing lanes
# A render that differs only by such flips sits far inside sample noise:
# its RMSE to the reference render is held to a quarter of the RMSE between
# two seeds of the reference render.
NOISE_SHARE = 0.25
# Whitted has no Russian roulette and is nearly deterministic.
WHITTED_CPU_RMSE_MAX = 1.0  # on the 0-255 scale
# The reference's published render against ours (the repo's parity bound).
WHITTED_REF_RMSE_MAX = 1.5
# Sharded sums change one addition order per pixel (the psum of partial
# sample sums); a rare branch flip may move a pixel further.
SHARD_RTOL, SHARD_PIXEL_SHARE = 1e-5, 0.9999
SHARD_U8_SHARE_MAX = 1e-4  # 8-bit pixels differing by more than 1


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def compare_bounce(got, want, rtol: float = FIELD_RTOL,
                   atol: float = FIELD_ATOL) -> dict:
    """Field-by-field comparison of two ``BounceOut`` records: the share of
    lanes whose hit/killed flags agree, and per float field the number of
    agreeing lanes outside ``rtol``/``atol``."""
    hit_g, hit_w = np.asarray(got.hit), np.asarray(want.hit)
    kill_g, kill_w = np.asarray(got.killed), np.asarray(want.killed)
    agree = (hit_g == hit_w) & (kill_g == kill_w)
    stats = {"agree_share": float(agree.mean()), "fields": {}}
    for name in got._fields:
        if name in ("hit", "killed"):
            continue
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, tuple):  # V3
            g, w = np.stack(g, -1), np.stack(w, -1)
            mask = agree[:, None]
        else:
            mask = agree
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        bad = ~np.isclose(g, w, rtol=rtol, atol=atol) & mask
        stats["fields"][name] = {
            "outside_tol": int(bad.sum()),
            "max_abs_diff": float(np.max(np.abs(g - w) * mask)),
        }
    return stats


def bounce_ok(stats: dict) -> bool:
    return stats["agree_share"] >= BRANCH_AGREE_MIN and all(
        f["outside_tol"] == 0 for f in stats["fields"].values()
    )


def sums_match(got, want, rtol: float = SHARD_RTOL) -> dict:
    """Per-pixel comparison of two ``(H*W, 3)`` radiance-sum arrays: the
    share of pixels whose three channels match to ``rtol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    close = np.isclose(got, want, rtol=rtol, atol=0.0).all(axis=-1)
    return {"pixel_share": float(close.mean()),
            "pixels_outside": int((~close).sum())}


def u8_outside_share(a, b, limit: int = 1) -> float:
    """Share of 8-bit channel values that differ by more than ``limit``."""
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    return float(np.mean(np.abs(a - b) > limit))


def select_phases(four_cards: bool):
    return FOUR_CARD_PHASES if four_cards else PHASES


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }})


def _check(ok, detail="check failed"):
    """A phase's check; raises (unlike ``assert``, also under ``-O``)."""
    if not ok:
        raise RuntimeError(detail)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _report(phase, **kw):
    parts = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{phase}] {parts}", flush=True)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---- phases -----------------------------------------------------------------

def phase_path(width=1024, height=1024, group=128, depth=8):
    import path_tracing__ray_tracer_tpu as ptrt

    b = ptrt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(width / height)
    settings = ptrt.RenderSettings(width, height, group, depth)

    def render(chunk_rays, offset):
        r = ptrt.RendererFactory.create(
            "tpu_path_raytracer", sample_group=group, chunk_rays=chunk_rays)
        return r, r.render_sums(scene, cam, settings, sample_offset=offset,
                                n_samples=group)

    (r, first), compile_s = _timed(lambda: render(1 << 24, 0))
    second, steady_s = _timed(lambda: r.render_sums(
        scene, cam, settings, sample_offset=group, n_samples=group))
    _check(np.isfinite(first).all() and np.isfinite(second).all())
    _check(not np.array_equal(first, second), "sample offsets not honored")
    again = r.render_sums(scene, cam, settings, sample_offset=group,
                          n_samples=group)
    _check(np.array_equal(again, second), "same-seed rerun not bit-identical")
    # a quarter of the chunk: another lane count, the same per-pixel sums up
    # to the branch flips described at NOISE_SHARE
    _r, quarter = render(1 << 22, group)
    diff = np.abs(quarter - second)
    flips = float(np.mean(diff > 1e-3 * np.maximum(1.0, np.abs(second))))
    _check(flips < 0.01 and diff.mean() < 1e-3 * group, (flips, diff.mean()))
    rays = width * height * group * depth
    _report("path", compile_s=round(compile_s, 3), steady_s=round(steady_s, 4),
            mrays_per_s=round(rays / steady_s / 1e6, 1),
            quarter_chunk_flip_share=flips,
            quarter_chunk_mean_abs_diff=float(diff.mean()),
            peak_bytes=_peak_bytes())


def _cornell_state(cs, cam12, n, width):
    """Camera rays of ``n`` pixels, and the rays after one XLA bounce."""
    import jax.numpy as jnp

    from path_tracing__ray_tracer_tpu.models.path_tracer import _bounce_xla
    from path_tracing__ray_tracer_tpu.ops import rng
    from path_tracing__ray_tracer_tpu.ops.camera import generate_rays
    from path_tracing__ray_tracer_tpu.ops.v3 import V3

    idx = jnp.arange(n, dtype=jnp.int32) + (width * width - n) // 2
    key = rng.ray_key(jnp.uint32(0), idx, 0)
    x = (idx % width).astype(jnp.float32)
    y = (idx // width).astype(jnp.float32)
    o, d = generate_rays(cam12, (x + 0.5) / width, (y + 0.5) / width)
    thr = V3.full(1.0, (n,))
    first = _bounce_xla(cs, o, d, thr, key, 0)
    thr2 = V3.full(0.7, (n,))
    return key, [("camera", o, d, thr, 0),
                 ("bounce1", first.new_org, first.new_dir, thr2, 1),
                 ("bounce3", first.new_org, first.new_dir, thr2, 3)]


def phase_bounce_kernel(lanes=131072, width=1024, group=128, depth=8, reps=5):
    import jax

    import path_tracing__ray_tracer_tpu as ptrt
    from path_tracing__ray_tracer_tpu.models.path_tracer import _bounce_xla
    from path_tracing__ray_tracer_tpu.ops.pallas import bounce_triton

    b = ptrt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(1.0)
    cs, cam12 = ptrt.compile_scene(scene), ptrt.pack_camera(cam)
    _check(bounce_triton.use_kernel(cs), "kernel gate declined the Cornell box")
    key, states = _cornell_state(cs, cam12, lanes, width)
    kern = jax.jit(lambda o, d, t, k, dp: bounce_triton.path_bounce(
        cs, o, d, t, k, dp))
    xla = jax.jit(lambda o, d, t, k, dp: _bounce_xla(cs, o, d, t, k, dp))
    for label, o, d, thr, dp in states:
        stats = compare_bounce(kern(o, d, thr, key, dp), xla(o, d, thr, key, dp))
        worst = max(stats["fields"].items(),
                    key=lambda kv: kv[1]["max_abs_diff"])
        _report("bounce_kernel", state=label,
                agree_share=stats["agree_share"],
                worst_field=worst[0], worst_max_abs_diff=worst[1]["max_abs_diff"],
                fields_outside_tol=sum(f["outside_tol"]
                                       for f in stats["fields"].values()))
        _check(bounce_ok(stats), stats)

    # full renders, kernel against XLA: a renderer plans its chunk function
    # (kernel or XLA bounce) at its first render, from bounce_triton.ENABLED
    settings = ptrt.RenderSettings(width, width, group, depth)

    def side(enabled, seed=0):
        bounce_triton.ENABLED = enabled
        try:
            r = ptrt.RendererFactory.create(
                "tpu_path_raytracer", sample_group=group, chunk_rays=1 << 24,
                seed=seed)
            img, compile_s = _timed(lambda: r.render_array(scene, cam, settings))
        finally:
            bounce_triton.ENABLED = True
        return r, img, compile_s

    r_x, img_x, cx = side(False)
    noise = rmse(img_x, side(False, seed=1)[1])
    r_k, img_k, ck = side(True)
    times = {"xla": [], "kernel": []}
    order = [("xla", r_x), ("kernel", r_k)]
    for i in range(reps):  # interleaved: xla, kernel, kernel, xla, ...
        for name, r in (order if i % 2 == 0 else order[::-1]):
            _, t = _timed(lambda: r.render_sums(scene, cam, settings))
            times[name].append(t)
    err = rmse(img_k, img_x)
    rays = width * width * group * depth
    _report("bounce_kernel", render=f"{width}x{width}x{group}spp_d{depth}",
            xla_compile_s=round(cx, 3), kernel_compile_s=round(ck, 3),
            xla_steady_s=sorted(times["xla"]),
            kernel_steady_s=sorted(times["kernel"]),
            xla_mrays_per_s=round(rays / float(np.median(times["xla"])) / 1e6, 1),
            kernel_mrays_per_s=round(
                rays / float(np.median(times["kernel"])) / 1e6, 1),
            rmse_kernel_vs_xla=err, rmse_seed_noise=noise)
    _check(err <= NOISE_SHARE * noise, (err, noise))


def phase_whitted(out_dir, width=2000, height=1500, spp=25, depth=16):
    import main as cli
    from PIL import Image

    from path_tracing__ray_tracer_tpu.utils.assets import reference_render_path

    out = os.path.join(out_dir, "whitted_cli_default.png")
    argv = ["-r", "tpu_texture_raytracer", "-w", str(width), "--height",
            str(height), "-s", str(spp), "-d", str(depth), "-o", out,
            "--no-show"]
    _, compile_s = _timed(lambda: cli.main(argv))
    _, steady_s = _timed(lambda: cli.main(argv))
    with Image.open(out) as im:
        ours = np.asarray(im.convert("RGB"))
    with Image.open(reference_render_path()) as im:
        ref = np.asarray(im.convert("RGB"))
    _check(ours.shape == ref.shape, (ours.shape, ref.shape))
    err = rmse(ours, ref)
    _report("whitted", compile_s=round(compile_s, 3), steady_s=round(steady_s, 4),
            rmse_vs_reference_255=round(err, 4))
    _check(err <= WHITTED_REF_RMSE_MAX, err)


def phase_card_vs_cpu(width=256, height=192, spp=16, depth=8):
    import path_tracing__ray_tracer_tpu as ptrt

    b = ptrt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(width / height)
    settings = ptrt.RenderSettings(width, height, spp, depth)

    def img(name, device=None, seed=0, repeat=False):
        r = ptrt.RendererFactory.create(name, device=device, seed=seed)
        out = _timed(lambda: np.asarray(r.render(scene, cam, settings)))
        if repeat:  # steady seconds: the same renderer again
            out = out + (_timed(lambda: r.render(scene, cam, settings))[1],)
        return out

    card, compile_s, steady_s = img("tpu_path_raytracer", repeat=True)
    cpu0, cpu_s = img("tpu_path_raytracer", device="cpu")
    cpu1, _ = img("tpu_path_raytracer", device="cpu", seed=1)
    err, noise = rmse(card, cpu0), rmse(cpu0, cpu1)
    w_card, w_compile_s = img("tpu_texture_raytracer")
    w_cpu, _ = img("tpu_texture_raytracer", device="cpu")
    w_err = rmse(w_card, w_cpu)
    _report("card_vs_cpu", path_compile_s=round(compile_s, 3),
            path_steady_s=round(steady_s, 4), path_cpu_s=round(cpu_s, 3), whitted_compile_s=round(w_compile_s, 3),
            path_rmse_card_vs_cpu=round(err, 4),
            path_rmse_cpu_seed0_vs_seed1=round(noise, 4),
            whitted_rmse_card_vs_cpu=round(w_err, 4))
    _check(err <= NOISE_SHARE * noise, (err, noise))
    _check(w_err <= WHITTED_CPU_RMSE_MAX, w_err)


def phase_mesh(out_dir, width=1920, height=1080, depth=12):
    import main as cli
    from PIL import Image

    from path_tracing__ray_tracer_tpu.compiler import compile_scene
    from path_tracing__ray_tracer_tpu.ops import bvh as bvh_mod
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
        MeshSceneBuilder,
    )

    for scene_name, spp, builder in (
        ("mesh", 4, MeshSceneBuilder()),
        ("mesh_big", 2, MeshSceneBuilder(grid=5, subdivisions=4)),
    ):
        cs = compile_scene(builder.build_scene(), with_textures=False)
        tris = cs.triangles
        v = [np.stack([np.asarray(c) for c in p], -1)
             for p in (tris.v0, tris.v1, tris.v2)]
        _, bvh_s = _timed(lambda: bvh_mod.build_bvh(
            np.minimum(np.minimum(v[0], v[1]), v[2]),
            np.maximum(np.maximum(v[0], v[1]), v[2])))
        out = os.path.join(out_dir, f"{scene_name}.png")
        argv = ["-r", "tpu_path_raytracer", "--scene", scene_name,
                "-w", str(width), "--height", str(height),
                "--path-samples", str(spp), "-d", str(depth),
                "--shadow-tmax", "light", "-o", out, "--no-show"]
        _, compile_s = _timed(lambda: cli.main(argv))
        _, steady_s = _timed(lambda: cli.main(argv))
        with Image.open(out) as im:
            px = np.asarray(im.convert("RGB")).astype(np.float64)
        _check(px.shape == (height, width, 3), px.shape)
        _check(5.0 < px.mean() < 250.0 and px.std() > 1.0, (px.mean(), px.std()))
        rays = width * height * spp * depth
        _report("mesh", scene=scene_name, triangles=int(tris.v0.x.shape[0]),
                bvh_nodes=cs.bvh.n_nodes, host_bvh_build_s=round(bvh_s, 3),
                compile_s=round(compile_s, 3), steady_s=round(steady_s, 4),
                mrays_per_s=round(rays / steady_s / 1e6, 2),
                image_mean=round(px.mean(), 2), peak_bytes=_peak_bytes())


def phase_four_cards(width=1024, height=1024, spp=64, depth=8, n_devices=4):
    import jax

    import path_tracing__ray_tracer_tpu as ptrt
    from path_tracing__ray_tracer_tpu.ops.tonemap import quantize_u8
    from path_tracing__ray_tracer_tpu.ops.v3 import V3
    from path_tracing__ray_tracer_tpu.parallel.mesh import make_mesh

    _check(len(jax.devices()) >= n_devices, jax.devices())
    b = ptrt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(width / height)
    settings = ptrt.RenderSettings(width, height, spp, depth)
    kw = dict(sample_group=spp, chunk_rays=1 << 24, seed=11)

    def u8(r, sums):
        img = r._finalize(sums, spp, settings)
        return np.asarray(quantize_u8(V3.from_array(img)).to_array())

    one = ptrt.RendererFactory.create("tpu_path_raytracer", **kw)
    ref, one_compile_s = _timed(lambda: one.render_sums(scene, cam, settings))
    _, one_s = _timed(lambda: one.render_sums(scene, cam, settings))
    ref_u8 = u8(one, ref)
    for sample_parallel in (1, n_devices // 2):
        mesh = make_mesh(n_devices, sample_parallel=sample_parallel)
        r = ptrt.RendererFactory.create("tpu_path_raytracer", mesh=mesh, **kw)
        got, compile_s = _timed(lambda: r.render_sums(scene, cam, settings))
        _, steady_s = _timed(lambda: r.render_sums(scene, cam, settings))
        # the sharded chunk's output lives on every card of the mesh
        fn, _n_pix, _group = r._plan(width, height, spp, depth)
        out = fn(r.compiled(scene), ptrt.pack_camera(cam), jax.numpy.int32(0),
                 jax.numpy.uint32(11), jax.numpy.int32(0))
        placed = len(out.x.sharding.device_set)
        match = sums_match(got, ref)
        u8_share = u8_outside_share(u8(r, got), ref_u8)
        _report("four_cards", mesh=dict(mesh.shape), devices_holding_output=placed,
                compile_s=round(compile_s, 3), steady_s=round(steady_s, 4),
                one_card_compile_s=round(one_compile_s, 3),
                one_card_steady_s=round(one_s, 4),
                pixel_share_within_rtol=match["pixel_share"],
                pixels_outside_rtol=match["pixels_outside"],
                u8_share_off_by_more_than_1=u8_share)
        _check(placed == n_devices, placed)
        _check(match["pixel_share"] >= SHARD_PIXEL_SHARE, match)
        _check(u8_share <= SHARD_U8_SHARE_MAX, u8_share)


# ---- driver -----------------------------------------------------------------

def _keep_cpu_backend():
    """Phase 4 needs the host CPU backend beside the GPU in this process: if
    the platforms are pinned without ``cpu``, add it after the GPU (which
    stays the default).  Must run before JAX's first device use."""
    import jax

    pinned = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    if pinned and "cpu" not in pinned.split(","):
        jax.config.update("jax_platforms", pinned + ",cpu")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card sharded render")
    parser.add_argument("--out-dir", default=os.path.join(REPO, "smoke_out"),
                        help="where rendered images are written")
    args = parser.parse_args(argv)

    _keep_cpu_backend()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, but JAX's default device is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2

    from path_tracing__ray_tracer_tpu.utils.backend import (
        enable_compile_cache,
        gpu_name_and_power_limit,
    )

    cache = enable_compile_cache()
    print(f"card: {gpu_name_and_power_limit()}")
    print(f"device_kind: {devices[0].device_kind}")
    print(f"jax: {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')}")
    print(f"compile cache: {cache}", flush=True)
    os.makedirs(args.out_dir, exist_ok=True)

    runners = {
        "path": phase_path,
        "bounce_kernel": phase_bounce_kernel,
        "whitted": lambda: phase_whitted(args.out_dir),
        "card_vs_cpu": phase_card_vs_cpu,
        "mesh": lambda: phase_mesh(args.out_dir),
        "four_cards": phase_four_cards,
    }
    for name in select_phases(args.four_cards):
        _, secs = _timed(runners[name])
        print(f"[{name}] passed in {secs:.1f} s", flush=True)
    n_used = 4 if args.four_cards else 1
    print(result_line(devices[:n_used]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
