"""CLI driver — flag-compatible with the reference ``main.py:24-46``.

Same flags, defaults and behaviors (path-sample override, capability listing,
Mrays/sec report); the renderer default maps the reference's
``cuda_texture_raytracer`` onto this package's ``tpu_texture_raytracer``, and
the reference's ``cuda_*`` names are accepted as aliases.  Extra flags are
additive: ``--seed``, ``--chunk-rays``, ``--progressive``, ``--checkpoint``,
``--devices``, ``--trace-dir``, ``--no-show``.  The compile cache follows
``JAX_COMPILATION_CACHE_DIR``, else ``<checkout>/.jax_cache``.
"""
from __future__ import annotations

import argparse
import sys
import time

from path_tracing__ray_tracer_tpu.core.scene import RenderSettings
from path_tracing__ray_tracer_tpu.models.base import RendererFactory
from path_tracing__ray_tracer_tpu.scene_builders.custom_scene_builder import (
    CustomSceneBuilder,
)
from path_tracing__ray_tracer_tpu.utils.logging import log_event
from path_tracing__ray_tracer_tpu.utils.profiling import maybe_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="JAX modular ray tracer with path tracing"
    )
    parser.add_argument(
        "--renderer",
        "-r",
        choices=RendererFactory.list_available(),
        default="tpu_texture_raytracer",
        help="renderer to use (reference cuda_* names are aliases)",
    )
    parser.add_argument(
        "--scene",
        choices=["original", "custom", "mesh", "mesh_big"],
        default="custom",
        help=(
            "scene selection ('original' is accepted-but-ignored for flag "
            "parity with the reference; 'mesh' is the 11.5K-triangle "
            "BVH-stress icosphere scene, 'mesh_big' the 128K-triangle one)"
        ),
    )
    parser.add_argument("--width", "-w", type=int, default=2000, help="image width")
    parser.add_argument("--height", type=int, default=1500, help="image height")
    parser.add_argument("--samples", "-s", type=int, default=25, help="samples per pixel")
    parser.add_argument("--depth", "-d", type=int, default=16, help="max bounce depth")
    parser.add_argument("--output", "-o", default="output.png", help="output file")
    parser.add_argument(
        "--path-samples",
        type=int,
        default=1024,
        help="samples per pixel for the path tracer",
    )
    # ---- additions beyond the reference's flags -----------------------------
    parser.add_argument("--seed", type=int, default=0, help="RNG seed")
    parser.add_argument(
        "--jitter",
        choices=["diagonal", "independent", "center"],
        default=None,
        help=(
            "pixel-jitter mode: 'diagonal' reproduces the reference's du==dv "
            "quirk (Whitted default), 'independent' is proper jitter (path "
            "default), 'center' pins samples for debugging"
        ),
    )
    parser.add_argument(
        "--debug-nans", action="store_true", help="enable JAX NaN checking (slow)"
    )
    parser.add_argument(
        "--shadow-tmax",
        choices=["reference", "light"],
        default="reference",
        help=(
            "path-tracer NEE occlusion bound: 'reference' reproduces the "
            "1e6 quirk (occluders beyond the light still shadow), 'light' "
            "bounds at the sampled light point (physically correct, faster "
            "for BVH scenes)"
        ),
    )
    parser.add_argument(
        "--texture-budget",
        type=int,
        default=0,
        help=(
            "cap texture max dimension (box-filtered atlas downsample); "
            "0 = reference-exact full resolution"
        ),
    )
    parser.add_argument(
        "--chunk-rays",
        type=int,
        default=None,
        help=(
            "ray-batch budget per device step (default: 1<<24 for the path "
            "tracer, 1<<21 otherwise)"
        ),
    )
    parser.add_argument(
        "--progressive",
        type=int,
        default=0,
        metavar="BATCH_SPP",
        help="render in progressive batches of this many spp (0 = one shot)",
    )
    parser.add_argument(
        "--checkpoint",
        default=None,
        help="accumulation checkpoint path for progressive renders (.npz)",
    )
    parser.add_argument(
        "--devices",
        type=int,
        default=0,
        help="shard the render across this many devices (0 = single device)",
    )
    parser.add_argument("--trace-dir", default=None, help="jax.profiler trace output dir")
    parser.add_argument("--no-show", action="store_true", help="do not open a viewer")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.renderer in ("tpu_path_raytracer", "cuda_path_raytracer"):
        effective_samples = args.path_samples
        print(f"Path tracer mode: {effective_samples} spp")
    else:
        effective_samples = args.samples
        print(f"Ray tracer mode: {effective_samples} spp")

    settings = RenderSettings(
        width=args.width,
        height=args.height,
        samples_per_pixel=effective_samples,
        max_depth=args.depth,
    )

    from path_tracing__ray_tracer_tpu.utils.backend import (
        enable_compile_cache,
        probe_backend,
    )

    enable_compile_cache()
    platform = probe_backend()
    print(f"Backend: {platform}")

    print(f"Building scene: {args.scene}")
    if args.scene in ("mesh", "mesh_big"):
        from path_tracing__ray_tracer_tpu.scene_builders.mesh_scene_builder import (
            MeshSceneBuilder,
        )

        builder = (MeshSceneBuilder(grid=5, subdivisions=4)
                   if args.scene == "mesh_big" else MeshSceneBuilder())
    else:
        builder = CustomSceneBuilder()
    scene = builder.build_scene()
    camera = builder.create_camera(args.width / args.height)

    print(f"Creating renderer: {args.renderer}")
    resolved_name = RendererFactory.resolve(args.renderer)
    chunk_rays = args.chunk_rays
    if chunk_rays is None:
        # path tracer: 1<<24 items / group 128 = 131072 lanes; Whitted
        # renderers keep a smaller chunk (each lane sweeps all 16 lights per
        # bounce).  When spp < 128 clamps the group, the renderer's
        # lane-width cap (wavefront._MAX_CHUNK_LANES) keeps 131072 lanes.
        # Both unmeasured on the H100.
        chunk_rays = 1 << 24 if resolved_name == "tpu_path_raytracer" else 1 << 21
    kwargs = {
        "chunk_rays": chunk_rays,
        "seed": args.seed,
        "texture_budget": args.texture_budget,
    }
    if args.jitter:
        kwargs["jitter"] = args.jitter
    if args.shadow_tmax != "reference":
        if RendererFactory.resolve(args.renderer) == "tpu_path_raytracer":
            kwargs["shadow_tmax"] = args.shadow_tmax
        else:
            print(
                f"Warning: --shadow-tmax {args.shadow_tmax} only applies to "
                "the path tracer; ignored for this renderer"
            )
    if args.devices:
        from path_tracing__ray_tracer_tpu.parallel.mesh import make_mesh

        kwargs["mesh"] = make_mesh(args.devices)
    renderer = RendererFactory.create(args.renderer, **kwargs)
    print(f"Capabilities: {', '.join(renderer.get_capabilities())}")

    # render-class notes (reference main.py:80-86 prints one per renderer
    # class)
    resolved = RendererFactory.resolve(args.renderer)
    if resolved == "tpu_path_raytracer":
        print("Rendering: Global Illumination")
    elif resolved == "cpu_raytracer":
        print("Estimated render time: 30-60s+ (CPU-parity oracle)")
        from path_tracing__ray_tracer_tpu.models.whitted_oracle import (
            ORACLE_MAX_DEPTH,
        )

        if args.depth > ORACLE_MAX_DEPTH:
            print(
                f"Note: cpu_raytracer clamps depth to {ORACLE_MAX_DEPTH} "
                f"(requested {args.depth}); fork chains beyond carry "
                "<0.85^12 of a glass path's energy (QUIRKS.md)"
            )
    else:
        print(f"Rendering: Whitted ray tracing on {platform}")

    from path_tracing__ray_tracer_tpu.utils.debug import debug_nans

    start = time.time()
    with maybe_trace(args.trace_dir), debug_nans(args.debug_nans):
        if args.progressive:
            from path_tracing__ray_tracer_tpu.parallel.progressive import (
                render_progressive,
            )

            image = render_progressive(
                renderer,
                scene,
                camera,
                settings,
                batch_spp=args.progressive,
                checkpoint_path=args.checkpoint,
            )
        else:
            image = renderer.render(scene, camera, settings)
    elapsed = time.time() - start

    image.save(args.output)
    print(f"Saved: {args.output}")
    minutes, seconds = int(elapsed // 60), elapsed % 60
    print(f"Total time: {minutes}m {seconds:.2f}s")

    if args.renderer in ("tpu_path_raytracer", "cuda_path_raytracer"):
        total_rays = args.width * args.height * effective_samples * args.depth
        print(
            f"Throughput: {total_rays / elapsed / 1e6:.2f}M rays/sec "
            f"({total_rays / 1e6:.1f}M rays total)"
        )

    # quality-tier summary (reference main.py:111-118)
    if resolved == "tpu_path_raytracer":
        print("Render quality: Global Illumination (highest)")
    elif resolved == "tpu_texture_raytracer":
        print("Render quality: Whitted ray tracing + textures (high)")
    elif resolved == "tpu_raytracer":
        print("Render quality: accelerated ray tracing (medium)")
    else:
        print("Render quality: CPU ray tracing (basic)")
    log_event(
        "cli_done",
        renderer=args.renderer,
        output=args.output,
        seconds=round(elapsed, 3),
    )

    if not args.no_show:
        try:
            image.show()
        except Exception:
            print("Viewer unavailable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
