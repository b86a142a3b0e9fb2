"""Shared wavefront render driver: chunking, jit caching, image assembly.

The reference launches one CUDA megakernel over a pixel grid
(``cuda_texture_renderer.py:769-773``); this design instead streams the
(pixel × sample) space through a jitted *chunk function* with static shapes:

* pixels are processed in fixed-size chunks (``chunk_rays`` budget), so
  arbitrarily large frames render in bounded device memory;
* samples are split into groups (progressive accumulation comes free);
* every chunk call has identical static shapes → exactly one XLA compilation
  per (scene-shape, settings) pair, reused across chunks, frames and
  progressive batches.

Subclasses provide ``_chunk_fn`` returning per-pixel radiance *sums* over the
group's samples; this driver accumulates into a float32 buffer, then the
subclass finalizes (divide by spp, tonemap) and quantizes.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler import CompiledScene, compile_scene, pack_camera, scene_summary
from ..core.camera import Camera
from ..core.scene import RenderSettings, Scene
from ..ops.tonemap import quantize_u8
from ..ops.v3 import V3
from ..utils.image import assemble_image
from ..utils.logging import log_event
from ..utils.profiling import Timer, mrays_per_sec
from .base import BaseRenderer


# Batched multi-chunk dispatch: when a render needs several pixel chunks, up
# to _DISPATCH_BATCH_MAX of them are driven by ONE jitted ``lax.map`` over
# chunk offsets (each mapped element running its full sample-group loop),
# cutting host dispatches ~K×.  The ray target caps per-executable work so
# large renders keep host/device pipelining.  Unmeasured on the H100.
_DISPATCH_TARGET_RAYS = 64_000_000
_DISPATCH_BATCH_MAX = 32
# Lane-width cap for one chunk dispatch.  ``_plan`` derives n_pix from
# chunk_rays // group and then caps it here, so a chunk default chosen for
# group 128 cannot silently double lane width when a lower spp clamps the
# group.  Unmeasured on the H100.
_MAX_CHUNK_LANES = 131072
# Device-sums group batching: when one pixel chunk's FULL sample loop stays
# under this ray budget (and the scene has no BVH, whose walks cost far more
# per ray), _render_device_u8 drives all of a chunk's sample groups with ONE
# dispatch (fori_loop inside the step) instead of one dispatch per group.
# Unmeasured on the H100.
_DEVICE_SUMS_TARGET_RAYS = 1_500_000_000


def pixel_coords(pix0, n_pix: int, width: int, height: int):
    """Flat pixel ids → (x, y measured from the bottom row).  Out-of-frame
    lanes are clamped to the last pixel; the driver discards them on host."""
    idx = pix0 + jnp.arange(n_pix, dtype=jnp.int32)
    total = width * height
    safe = jnp.minimum(idx, total - 1)
    x = (safe % width).astype(jnp.float32)
    y = (safe // width).astype(jnp.float32)
    return idx, x, y


class WavefrontRenderer(BaseRenderer):
    convention = "gpu"
    gpu_parity = True
    progress_label: str = None  # set by slow renderers for per-chunk prints

    def __init__(
        self,
        name: str,
        chunk_rays: int = 1 << 20,
        seed: int = 0,
        jitter: str = "diagonal",  # 'diagonal' (reference quirk) | 'independent' | 'center'
        mesh=None,
        texture_budget: int = 0,  # 0 = reference-exact full-res atlas
        compile_overrides: Optional[dict] = None,  # extra compile_scene kwargs
        device: Optional[str] = None,  # None = session default; "cpu" = host
        reseed_per_render: bool = False,  # reference frame_count reseed quirk
    ):
        super().__init__(name)
        self.chunk_rays = int(chunk_rays)
        self.seed = int(seed)
        # Opt-in parity with the reference's per-render RNG advance: its
        # frame_count reseeds the kernel each render() call
        # (cuda_path_tracer.py:28,739,809), so back-to-back renders in one
        # process produce different noise.  Default off — renders stay
        # deterministic per (seed, settings), the documented invariant
        # (QUIRKS.md); progressive accumulation is the better replacement.
        self.reseed_per_render = bool(reseed_per_render)
        assert jitter in ("diagonal", "independent", "center"), jitter
        self.jitter = jitter
        self.mesh = mesh
        self.texture_budget = int(texture_budget)
        self.compile_overrides = dict(compile_overrides or {})
        self.device = device
        self._scene_cache: Dict[Tuple[int, str, bool], CompiledScene] = {}
        self._jit_cache: Dict[Tuple, Callable] = {}
        # progressive-accumulation hook (reference frame_count analogue,
        # cuda_path_tracer.py:739)
        self.frame_count = 0

    def _run_seed(self) -> int:
        """Seed for this render: mixes ``frame_count`` in when the reference
        reseed quirk is opted in (``ray_key`` hashes the seed, so +1 yields an
        independent stream, matching the reference's ``seed + frame_count``
        behavior at cuda_path_tracer.py:28)."""
        if self.reseed_per_render:
            return (self.seed + self.frame_count) & 0xFFFFFFFF
        return self.seed

    # -- execution placement ---------------------------------------------------
    def _device_scope(self):
        """Context placing this renderer's arrays/compute on an explicit
        backend.  ``device="cpu"`` pins the host CPU (the reference's
        ``cpu_raytracer`` is host-only, ``cpu_renderer.py``).  ``None`` keeps
        the session default.  A requested backend that is absent raises."""
        import contextlib

        if self.device is None:
            return contextlib.nullcontext()
        try:
            dev = jax.devices(self.device)[0]
        except RuntimeError as exc:
            raise RuntimeError(
                f"renderer {self.name!r} needs the {self.device!r} backend, "
                f"which this JAX process does not have ({exc})"
            ) from exc
        return jax.default_device(dev)

    # -- scene compilation (cached) -----------------------------------------
    def compiled(self, scene: Scene) -> CompiledScene:
        key = (id(scene), self.convention, self.gpu_parity, self.texture_budget,
               self.device, tuple(sorted(self.compile_overrides.items())))
        if key not in self._scene_cache:
            with self._device_scope():
                cs = compile_scene(
                    scene,
                    convention=self.convention,
                    gpu_parity=self.gpu_parity,
                    texture_budget=self.texture_budget,
                    **self.compile_overrides,
                )
            self._scene_cache[key] = cs
            log_event("scene_compiled", renderer=self.name, **scene_summary(cs))
        return self._scene_cache[key]

    # -- subclass contract ---------------------------------------------------
    def _samples_per_group(self, spp: int) -> int:
        """How many samples one chunk call integrates (whole grid for the
        Whitted grid sampler, bounded groups for the path tracer)."""
        raise NotImplementedError

    def _make_chunk_fn(self, static_key: Tuple) -> Callable:
        """Return jitted ``f(cs, cam12, pix0, seed, sample_base) -> (n_pix, 3)``
        radiance sums for this group's samples."""
        raise NotImplementedError

    def _finalize_dev(self, sums, spp_total: int, settings: RenderSettings):
        """Radiance sums → display-ready [0,1] float image (pre-quantization).
        Pure jnp math — runs on device, traceable inside the fused one-shot
        dispatch (``_render_fused_u8``)."""
        raise NotImplementedError

    def _finalize(self, sums: np.ndarray, spp_total: int, settings: RenderSettings) -> np.ndarray:
        """Host-array wrapper over ``_finalize_dev``."""
        return np.asarray(self._finalize_dev(jnp.asarray(sums), spp_total, settings))

    # -- chunk-plan construction (single device or mesh) ----------------------
    def _plan(self, w: int, h: int, spp: int, max_depth: int):
        """Choose chunk geometry and build (or fetch) the chunk callable.

        Returns ``(chunk_fn, n_pix, group)`` where ``chunk_fn`` produces sums
        over ``group`` samples for ``n_pix`` pixels.  With a mesh attached the
        pixel chunk is split over the ``tile`` axis and the sample group over
        the ``sample`` axis (partials psum-reduced) — same compiled kernel per
        device as the single-chip path.
        """
        group = self._samples_per_group(spp)
        n_pix = max(1024, min(w * h, max(1, self.chunk_rays // max(group, 1)),
                              _MAX_CHUNK_LANES))
        n_pix = int(math.ceil(n_pix / 1024) * 1024)

        if self.mesh is None:
            static_key = (n_pix, w, h, spp, max_depth, group, self.jitter)
            if static_key not in self._jit_cache:
                self._jit_cache[static_key] = self._make_chunk_fn(static_key)
            return self._jit_cache[static_key], n_pix, group

        from ..parallel.mesh import mesh_shape
        from ..parallel.sharding import shard_chunk_fn

        tile, samp = mesh_shape(self.mesh)
        local_samples = max(1, -(-group // samp))  # ceil; chunk fns mask overshoot
        n_pix = int(math.ceil(n_pix / (tile * 1024)) * tile * 1024)
        local_pix = n_pix // tile
        cache_key = (local_pix, w, h, spp, max_depth, local_samples,
                     self.jitter, tile, samp)
        if cache_key not in self._jit_cache:
            inner = self._make_chunk_fn(
                (local_pix, w, h, spp, max_depth, local_samples, self.jitter)
            )
            self._jit_cache[cache_key] = jax.jit(
                shard_chunk_fn(inner, self.mesh, local_pix, local_samples)
            )
        return self._jit_cache[cache_key], n_pix, group

    # -- driver ---------------------------------------------------------------
    def render_sums(
        self,
        scene: Scene,
        camera: Camera,
        settings: RenderSettings,
        sample_offset: int = 0,
        n_samples: Optional[int] = None,
    ) -> np.ndarray:
        """Accumulate radiance sums over ``n_samples`` samples starting at
        ``sample_offset`` — the building block for both one-shot and
        progressive rendering.  Returns float32 ``(H*W, 3)`` sums."""
        cs = self.compiled(scene)
        with self._device_scope():
            cam12 = pack_camera(camera)
        w, h, spp = settings.width, settings.height, settings.samples_per_pixel
        if n_samples is None:
            n_samples = spp

        chunk_fn, n_pix, group = self._plan(w, h, spp, settings.max_depth)

        log_event(
            "render_start",
            renderer=self.name,
            width=w,
            height=h,
            spp=n_samples,
            max_depth=settings.max_depth,
            chunk_pixels=n_pix,
            sample_group=group,
            chunks=-(-w * h // n_pix),
        )

        # dispatch every chunk asynchronously, then fetch once: device compute
        # pipelines ahead of the host.  Small multi-chunk renders additionally
        # batch several pixel chunks into one lax.map dispatch (see module
        # consts).
        pix0_list = list(range(0, w * h, n_pix))
        batch_k = self._dispatch_batch(
            cs, n_pix, n_samples, settings.max_depth, len(pix0_list)
        )

        pending = []  # (list_of_pix0, device_array (k, n_pix, 3))
        with self._device_scope():
            if batch_k > 1:
                n_groups = -(-n_samples // group)
                for b0 in range(0, len(pix0_list), batch_k):
                    batch = pix0_list[b0 : b0 + batch_k]
                    fn = self._batched_fn(chunk_fn, len(batch), n_groups, group)
                    out = fn(
                        cs,
                        cam12,
                        jnp.asarray(batch, jnp.int32),
                        jnp.uint32(self._run_seed()),
                        jnp.int32(sample_offset),
                    )
                    pending.append((batch, out.to_array()))
            else:
                for pix0 in pix0_list:
                    chunk_sum = None
                    for s0 in range(sample_offset, sample_offset + n_samples, group):
                        out = chunk_fn(
                            cs,
                            cam12,
                            jnp.int32(pix0),
                            jnp.uint32(self._run_seed()),
                            jnp.int32(s0),
                        )
                        chunk_sum = out if chunk_sum is None else jax.tree.map(jnp.add, chunk_sum, out)
                    pending.append(([pix0], chunk_sum.to_array()[None]))

        sums = np.zeros((w * h, 3), dtype=np.float32)
        for batch, block_dev in pending:
            block = np.asarray(block_dev)  # blocks until this batch computes
            for k, pix0 in enumerate(batch):
                take = min(n_pix, w * h - pix0)
                sums[pix0 : pix0 + take] += block[k, :take]
                if self.progress_label and len(pix0_list) > 1:
                    # in-flight progress, the analogue of the reference CPU
                    # renderer's every-50-rows print (cpu_renderer.py:64-65)
                    rows_done = min(h, (pix0 + take) // max(w, 1))
                    print(f"{self.progress_label}: {rows_done}/{h} rows")
        return sums

    def _render_fused_u8(self, scene, camera, settings):
        """One-dispatch render: chunk ``lax.map`` + finalize + quantize fused
        into a single executable, transferring only the uint8 image.

        For small renders the separate sums transfer (f32, 4× the bytes) and
        the finalize/quantize round trips can cost more than the compute.
        Returns the (H*W, 3) uint8 host array, or None when
        the render doesn't fit one dispatch (the caller then uses the
        pipelined multi-dispatch path, which is not floor-bound).  Bit-exact
        vs the unfused path: same chunk sums, same finalize/quantize ops,
        only the host bounces removed."""
        if self.mesh is not None or not self.gpu_parity:
            return None
        w, h, spp = settings.width, settings.height, settings.samples_per_pixel
        cs = self.compiled(scene)
        chunk_fn, n_pix, group = self._plan(w, h, spp, settings.max_depth)
        pix0_list = list(range(0, w * h, n_pix))
        batch_k = self._dispatch_batch(
            cs, n_pix, spp, settings.max_depth, len(pix0_list)
        )
        if len(pix0_list) > 1 and batch_k < len(pix0_list):
            return None
        log_event(
            "render_start",
            renderer=self.name,
            width=w,
            height=h,
            spp=spp,
            max_depth=settings.max_depth,
            chunk_pixels=n_pix,
            sample_group=group,
            chunks=len(pix0_list),
            fused="u8",
        )
        n_groups = -(-spp // group)
        with self._device_scope():
            cam12 = pack_camera(camera)
            fn = self._fused_u8_fn(
                chunk_fn, len(pix0_list), n_groups, group, w, h, spp, settings
            )
            out = fn(
                cs,
                cam12,
                jnp.asarray(pix0_list, jnp.int32),
                jnp.uint32(self._run_seed()),
                jnp.int32(0),
            )
            arr = np.asarray(out)  # single host sync + u8 transfer
        if self.progress_label and len(pix0_list) > 1:
            print(f"{self.progress_label}: {h}/{h} rows")
        return arr

    def _fused_u8_fn(self, chunk_fn: Callable, k: int, n_groups: int,
                     group: int, w: int, h: int, spp: int, settings):
        """Jitted ``(cs, cam12, pix0s, seed, s0_base) -> (H*W, 3) uint8`` —
        the ``_batched_fn`` chunk loop with the display pipeline appended."""
        key = (id(chunk_fn), k, n_groups, group, w, h, spp, "u8")
        if key not in self._jit_cache:
            total = w * h

            def run(cs, cam12, pix0s, seed, s0_base):
                def one(pix0):
                    acc = chunk_fn(cs, cam12, pix0, seed, s0_base)

                    def body(i, a):
                        return jax.tree.map(
                            jnp.add, a,
                            chunk_fn(cs, cam12, pix0, seed, s0_base + i * group),
                        )

                    if n_groups > 1:
                        acc = jax.lax.fori_loop(1, n_groups, body, acc)
                    return acc

                sums = jax.lax.map(one, pix0s)  # V3 of (k, n_pix)
                flat = sums.to_array().reshape(-1, 3)[:total]
                img = self._finalize_dev(flat, spp, settings)
                rgb = quantize_u8(V3.from_array(img))
                return rgb.to_array()

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _dispatch_batch(
        self, cs, n_pix: int, n_samples: int, max_depth: int, n_chunks: int
    ) -> int:
        """How many pixel chunks one dispatch should drive.  Batches only the
        small fast renders that are floor-bound: single-device, GPU-parity
        renderers (the oracle's fork cost is not captured by the ray count),
        brute-force scenes (BVH chunks run ~20× slower per ray), and only
        while total per-dispatch work stays under the ray target."""
        if n_chunks <= 1 or self.mesh is not None or not self.gpu_parity:
            return 1
        if getattr(cs, "bvh", None) is not None:
            return 1
        rays_per_chunk = max(1, n_pix * n_samples * max_depth)
        return int(
            min(n_chunks, _DISPATCH_BATCH_MAX,
                max(1, _DISPATCH_TARGET_RAYS // rays_per_chunk))
        )

    def _batched_fn(self, chunk_fn: Callable, k: int, n_groups: int, group: int):
        """One jitted dispatch driving ``k`` pixel chunks via ``lax.map``;
        each mapped element accumulates its ``n_groups`` sample groups with
        the same sequential adds as the unbatched host loop (bit-compatible
        accumulation order)."""
        key = (id(chunk_fn), k, n_groups, group)
        if key not in self._jit_cache:

            def run(cs, cam12, pix0s, seed, s0_base):
                def one(pix0):
                    acc = chunk_fn(cs, cam12, pix0, seed, s0_base)

                    def body(i, a):
                        return jax.tree.map(
                            jnp.add, a,
                            chunk_fn(cs, cam12, pix0, seed, s0_base + i * group),
                        )

                    if n_groups > 1:
                        acc = jax.lax.fori_loop(1, n_groups, body, acc)
                    return acc

                return jax.lax.map(one, pix0s)

            self._jit_cache[key] = jax.jit(run)
        return self._jit_cache[key]

    def _render_device_u8(self, scene, camera, settings):
        """Multi-dispatch render with DEVICE-resident accumulation: each chunk's
        sums scatter into a device buffer (async, no host bounce), then ONE
        fused finalize+quantize dispatch transfers only the uint8 image.

        The unfused path moves the f32 sums host→device→host→device→host
        around finalize/quantize (~75 MB for a 1080p render).
        Per-pixel accumulation order is identical to the host path (each
        pixel belongs to one chunk; groups add in the same sequence), so the
        image is bit-identical.  Returns the (H*W, 3) uint8 host array, or
        None when this render should use another path (mesh sharding and
        progress-printing renderers keep the host loop)."""
        if self.mesh is not None or not self.gpu_parity or self.progress_label:
            return None
        w, h, spp = settings.width, settings.height, settings.samples_per_pixel
        cs = self.compiled(scene)
        chunk_fn, n_pix, group = self._plan(w, h, spp, settings.max_depth)
        pix0_list = list(range(0, w * h, n_pix))
        if len(pix0_list) <= 1:
            return None  # single chunk: the fused-u8 path already covers it
        if self._dispatch_batch(cs, n_pix, spp, settings.max_depth,
                                len(pix0_list)) > 1:
            return None  # small floor-bound renders keep the batched lax.map
        log_event(
            "render_start",
            renderer=self.name,
            width=w,
            height=h,
            spp=spp,
            max_depth=settings.max_depth,
            chunk_pixels=n_pix,
            sample_group=group,
            chunks=len(pix0_list),
            fused="device_sums",
        )
        pad = len(pix0_list) * n_pix

        # group batching: one dispatch per chunk when the full sample loop
        # fits the per-executable ray budget (see _DEVICE_SUMS_TARGET_RAYS).
        # The fori accumulates groups in the same ascending order as the
        # per-group host loop, so the image stays bit-identical.
        n_groups = -(-spp // group)
        fuse_groups = (
            n_groups > 1
            and getattr(cs, "bvh", None) is None
            and n_pix * spp * settings.max_depth <= _DEVICE_SUMS_TARGET_RAYS
        )

        key_acc = ("dev_acc", id(chunk_fn), n_pix, group, fuse_groups)
        if key_acc not in self._jit_cache:
            if fuse_groups:
                def acc_step(buf, cs_, cam12_, pix0, seed, s0):
                    acc = chunk_fn(cs_, cam12_, pix0, seed, s0)

                    def body(i, a):
                        return jax.tree.map(
                            jnp.add, a,
                            chunk_fn(cs_, cam12_, pix0, seed, s0 + i * group),
                        )

                    acc = jax.lax.fori_loop(1, n_groups, body, acc)
                    return jax.lax.dynamic_update_slice(
                        buf, acc.to_array(), (pix0, jnp.int32(0))
                    )
            else:
                def acc_step(buf, cs_, cam12_, pix0, seed, s0):
                    out = chunk_fn(cs_, cam12_, pix0, seed, s0)
                    return jax.lax.dynamic_update_slice(
                        buf, out.to_array(), (pix0, jnp.int32(0))
                    )

            self._jit_cache[key_acc] = jax.jit(acc_step, donate_argnums=(0,))

        key_add = ("dev_add", id(chunk_fn), n_pix, group)
        if not fuse_groups and key_add not in self._jit_cache:
            def add_step(buf, cs_, cam12_, pix0, seed, s0):
                out = chunk_fn(cs_, cam12_, pix0, seed, s0)
                cur = jax.lax.dynamic_slice(buf, (pix0, jnp.int32(0)), (n_pix, 3))
                return jax.lax.dynamic_update_slice(
                    buf, cur + out.to_array(), (pix0, jnp.int32(0))
                )

            self._jit_cache[key_add] = jax.jit(add_step, donate_argnums=(0,))

        key_fin = ("dev_fin", w, h, spp, settings.max_depth)
        if key_fin not in self._jit_cache:
            def fin(buf):
                img = self._finalize_dev(buf[: w * h], spp, settings)
                return quantize_u8(V3.from_array(img)).to_array()

            self._jit_cache[key_fin] = jax.jit(fin)

        with self._device_scope():
            cam12 = pack_camera(camera)
            buf = jnp.zeros((pad, 3), jnp.float32)
            for pix0 in pix0_list:
                if fuse_groups:
                    buf = self._jit_cache[key_acc](
                        buf, cs, cam12, jnp.int32(pix0),
                        jnp.uint32(self._run_seed()), jnp.int32(0),
                    )
                    continue
                for gi, s0 in enumerate(range(0, spp, group)):
                    step = self._jit_cache[key_acc if gi == 0 else key_add]
                    buf = step(
                        buf, cs, cam12, jnp.int32(pix0),
                        jnp.uint32(self._run_seed()), jnp.int32(s0),
                    )
            arr = np.asarray(self._jit_cache[key_fin](buf))
        return arr

    def render_array(self, scene: Scene, camera: Camera, settings: RenderSettings) -> np.ndarray:
        """Float image in [0,1], shape (H*W, 3), bottom-up row order."""
        sums = self.render_sums(scene, camera, settings)
        return self._finalize(sums, settings.samples_per_pixel, settings)

    def render(self, scene: Scene, camera: Camera, settings: RenderSettings):
        with Timer() as t:
            arr = self._render_fused_u8(scene, camera, settings)
            if arr is None:
                arr = self._render_device_u8(scene, camera, settings)
            if arr is None:
                img = self.render_array(scene, camera, settings)
                rgb = quantize_u8(V3.from_array(jnp.asarray(img)))
                arr = np.asarray(rgb.to_array())
        self.frame_count += 1
        log_event(
            "render_done",
            renderer=self.name,
            seconds=round(t.seconds, 3),
            mrays_per_sec=round(
                mrays_per_sec(
                    settings.width,
                    settings.height,
                    settings.samples_per_pixel,
                    settings.max_depth,
                    t.seconds,
                ),
                2,
            ),
        )
        return assemble_image(arr, settings.width, settings.height)
