"""Benchmark: Cornell-box path tracing throughput on one GPU.

Prints exactly ONE JSON line on stdout:
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}``,
with the card's name and power limit in ``detail``.  Exits 2 without
printing a result unless JAX's default device is a GPU.

Metric: Mrays/sec by the reference's own formula (``main.py:104-108``:
``W·H·spp·depth / seconds``).  Baseline 136 Mrays/sec is the reference's
derived hero-render throughput on an RTX 2070 Super (BASELINE.md).  Warm-up
batch excluded (jit compile); the measured phase renders BATCHES sample
groups of the 1024×1024 Cornell box at depth 8.
"""
from __future__ import annotations

import json
import sys
import time

BASELINE_MRAYS = 136.0  # RTX 2070 Super, derived in BASELINE.md

WIDTH = HEIGHT = 1024
DEPTH = 8
# large sample groups amortize the regeneration tail phase and per-call
# dispatch (131072 lanes per chunk); unmeasured on the H100
GROUP_SPP = 128
CHUNK_RAYS = 1 << 24
BATCHES = 3
# 0 = the reference-exact full-resolution atlas (a texture budget is lossy)
TEXTURE_BUDGET = 0


def main() -> int:
    import os

    import jax

    import path_tracing__ray_tracer_tpu as ptrt
    from path_tracing__ray_tracer_tpu.utils.backend import (
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    require_gpu("bench")
    enable_compile_cache()
    card = gpu_name_and_power_limit()

    builder = ptrt.CustomSceneBuilder()
    scene = builder.build_scene()
    camera = builder.create_camera(WIDTH / HEIGHT)
    settings = ptrt.RenderSettings(
        width=WIDTH, height=HEIGHT, samples_per_pixel=GROUP_SPP, max_depth=DEPTH
    )
    renderer = ptrt.RendererFactory.create(
        "tpu_path_raytracer", sample_group=GROUP_SPP, chunk_rays=CHUNK_RAYS,
        texture_budget=TEXTURE_BUDGET,
    )

    dev = jax.devices()[0]
    print(f"bench: {card} device_kind={dev.device_kind} "
          f"devices={len(jax.devices())}", file=sys.stderr)

    # warm-up (compile + first run)
    t0 = time.time()
    renderer.render_sums(scene, camera, settings, sample_offset=0, n_samples=GROUP_SPP)
    warmup_s = time.time() - t0
    print(f"bench: warmup {warmup_s:.1f}s (compile included)", file=sys.stderr)

    # measured phase: per-batch timing, headline from the fastest batch; all
    # batch times ride in `detail`
    batch_secs = []
    for b in range(1, BATCHES + 1):
        t0 = time.time()
        renderer.render_sums(
            scene, camera, settings,
            sample_offset=b * GROUP_SPP, n_samples=GROUP_SPP,
        )
        batch_secs.append(time.time() - t0)
    elapsed = min(batch_secs)

    spp_measured = GROUP_SPP
    total_rays = WIDTH * HEIGHT * spp_measured * DEPTH
    mrays = total_rays / elapsed / 1e6
    spp_per_min = spp_measured / elapsed * 60.0

    # secondary: the reference README's own benchmark — Whitted CLI defaults
    # (2000×1500, 25 spp, depth 16) took 18 s on its RTX 2070 Super; also the
    # pixel-RMSE against the reference's published render of that exact config
    whitted = ptrt.RendererFactory.create("tpu_texture_raytracer", chunk_rays=1 << 21)
    wsettings = ptrt.RenderSettings(
        width=2000, height=1500, samples_per_pixel=25, max_depth=16
    )
    wcam = ptrt.CustomSceneBuilder().create_camera(2000 / 1500)
    whitted.render(scene, wcam, wsettings)  # warmup/compile (full pipeline)
    t0 = time.time()
    wimg = whitted.render(scene, wcam, wsettings)
    whitted_s = time.time() - t0

    from path_tracing__ray_tracer_tpu.utils.assets import reference_render_path

    rmse_255 = None
    ref_png = reference_render_path()
    if ref_png and os.path.exists(ref_png):
        import numpy as np
        from PIL import Image

        ours = np.asarray(wimg).astype(np.float64)
        with Image.open(ref_png) as im:
            ref = np.asarray(im.convert("RGB")).astype(np.float64)
        if ours.shape == ref.shape:
            rmse_255 = float(np.sqrt(((ours - ref) ** 2).mean()))

    result = {
        "metric": "cornell_path_trace_mrays_per_sec",
        "value": round(mrays, 2),
        "unit": "Mrays/sec",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "detail": {
            "resolution": f"{WIDTH}x{HEIGHT}",
            "depth": DEPTH,
            "spp_measured": spp_measured,
            "seconds": round(elapsed, 3),
            "batch_seconds": [round(s, 3) for s in batch_secs],
            "spp_per_min_1024sq": round(spp_per_min, 1),
            "est_seconds_1024spp": round(1024 / spp_measured * elapsed, 1),
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": card,
            "warmup_seconds": round(warmup_s, 1),
            "whitted_cli_default_seconds": round(whitted_s, 2),
            "whitted_vs_reference_18s": round(18.0 / whitted_s, 2),
            "whitted_rmse_vs_reference_png_255": (
                round(rmse_255, 3) if rmse_255 is not None else None
            ),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
