"""The five BASELINE.json benchmark configurations, end to end, on one GPU.

``bench.py`` stays the single-line contract; this script runs the full
matrix and prints one JSON line per config, each with the card's name and
power limit:

1. Cornell spheres-only Whitted (cpu_raytracer parity, on the host by
   design), 256², 1 spp
2. Cornell diffuse path trace, 512², 64 spp, depth 4
3. Textured Cornell (cuda_texture_renderer parity), 512², 256 spp
4. Glass + mirror caustics (hero config), 1024², 1024 spp, depth 8, RR
5. Triangle-mesh-heavy BVH stress, 1920×1080, 512 spp, wavefront depth 12

Usage:  python benchmarks.py [--configs 1,2,3] [--scale 0.25]
``--scale`` shrinks spp (not resolution) for quick runs.  Exits 2 without
printing a result unless JAX's default device is a GPU.

The steady phase repeats varied-seed renders until ≥2.5 s of measured work
accumulates (≤5 reps), reporting the mean and the per-rep times.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def run_config(idx: int, scale: float, card: str) -> dict:
    import path_tracing__ray_tracer_tpu as ptrt
    from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
        MeshSceneBuilder,
    )

    cornell = ptrt.CustomSceneBuilder()

    def spp(n):
        return max(1, int(n * scale))

    configs = {
        1: ("cpu_raytracer", cornell, dict(width=256, height=256,
                                           samples_per_pixel=1, max_depth=4), {}),
        2: ("tpu_path_raytracer", cornell, dict(width=512, height=512,
                                                samples_per_pixel=spp(64), max_depth=4),
            dict(texture_budget=256)),
        3: ("tpu_texture_raytracer", cornell, dict(width=512, height=512,
                                                   samples_per_pixel=spp(256),
                                                   max_depth=8), {}),
        4: ("tpu_path_raytracer", cornell, dict(width=1024, height=1024,
                                                samples_per_pixel=spp(1024),
                                                max_depth=8),
            dict(texture_budget=256, sample_group=128, chunk_rays=1 << 24)),
        # mesh-heavy BVH stress through the XLA BVH walk (ops/bvh.py).
        # shadow_tmax="light" bounds NEE occlusion at the light (this scene
        # is not a reference-parity target, so the physically-correct bound
        # ships).  At scaled-down spp the group clamps and the lane-width cap
        # (wavefront._MAX_CHUNK_LANES) keeps 131072 lanes.
        5: ("tpu_path_raytracer", MeshSceneBuilder(grid=3, subdivisions=3),
            dict(width=1920, height=1080, samples_per_pixel=spp(512), max_depth=12),
            dict(sample_group=128, chunk_rays=1 << 24, shadow_tmax="light",
                 compile_overrides={"use_bvh": True})),
        # 128,000-triangle stress — 25 icospheres at 4 subdivisions.  Run
        # explicitly with --configs 6; not part of the BASELINE.json five.
        6: ("tpu_path_raytracer", MeshSceneBuilder(grid=5, subdivisions=4),
            dict(width=1920, height=1080, samples_per_pixel=spp(512), max_depth=12),
            dict(sample_group=128, chunk_rays=1 << 24, shadow_tmax="light",
                 compile_overrides={"use_bvh": True})),
    }
    renderer_name, builder, cfg, kwargs = configs[idx]
    scene = builder.build_scene()
    camera = builder.create_camera(cfg["width"] / cfg["height"])
    settings = ptrt.RenderSettings(**cfg)
    renderer = ptrt.RendererFactory.create(renderer_name, **kwargs)

    # warmup run absorbs the compiles
    renderer.seed = 1
    t0 = time.time()
    renderer.render(scene, camera, settings)
    warmup = time.time() - t0

    # steady phase: varied-seed reps until >=2.5 s of measured work (<=5)
    rep_seconds = []
    for rep in range(5):
        renderer.seed = rep * 7 + 2
        t0 = time.time()
        image = renderer.render(scene, camera, settings)
        rep_seconds.append(time.time() - t0)
        del image
        if sum(rep_seconds) >= 2.5:
            break
    elapsed = sum(rep_seconds) / len(rep_seconds)

    total_rays = cfg["width"] * cfg["height"] * cfg["samples_per_pixel"] * cfg["max_depth"]
    return {
        "config": idx,
        "renderer": renderer_name,
        "resolution": f"{cfg['width']}x{cfg['height']}",
        "spp": cfg["samples_per_pixel"],
        "spp_scale": scale,  # explicit: spp above is already scaled by this
        "max_depth": cfg["max_depth"],
        "seconds": round(elapsed, 2),
        "rep_seconds": [round(t, 2) for t in rep_seconds],
        "warmup_seconds": round(warmup, 2),
        "mrays_per_sec": round(total_rays / elapsed / 1e6, 2),
        "card": card,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--configs", default="1,2,3,4,5")
    parser.add_argument("--scale", type=float, default=1.0)
    args = parser.parse_args(argv)

    from path_tracing__ray_tracer_tpu.utils.backend import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu("benchmarks")
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    for idx in (int(c) for c in args.configs.split(",")):
        result = run_config(idx, args.scale, card)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
