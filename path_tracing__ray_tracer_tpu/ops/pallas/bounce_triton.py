"""Fused per-bounce path-tracer kernel for the GPU (Pallas, Triton route).

The upstream renderer is a Numba-CUDA megakernel: one thread per pixel runs
the whole bounce in registers and brute-forces every primitive from flat
``float32`` arrays.  This kernel is that design for one bounce of the
wavefront driver: each program takes a 1-D block of ``BLOCK`` rays and runs
the closest-hit sweep, the NEE light pick and shadow sweep, Russian roulette
and the scatter event without leaving registers, then writes the
``BounceOut`` record (``ops/bounce.py``).

The physics is not written twice.  The kernel body calls
``models.path_tracer._bounce_xla`` itself, on ``(BLOCK,)`` values, with the
scene replaced by *table views*: every field of the compiled scene lives at
an offset in one flat ``float32`` operand, and a view column reads
``table[offset + i]`` — a scalar load for the sweep's loop index, a per-lane
gather for the winner's attributes.  The broadcast (N, P) sweep of the XLA
path becomes ``intersect.closest_sequential``/``any_sequential``: one
``fori_loop`` per primitive type, reading each primitive as scalars.  Only
broadcast-class scenes (no BVH, at most ``BROADCAST_LIMIT`` primitives) take
this kernel.

``use_kernel`` is the one gate.  It chooses the kernel on the ``gpu``
platform for broadcast-class scenes.  ``INTERPRET = True`` (tests) runs the
same kernel through the Pallas interpreter on the CPU; on the GPU the
compiled kernel always runs.  ``ENABLED = False`` makes renderers created
afterwards plan the XLA formulation instead (the A/B switch; it is part of
the path tracer's compiled chunk key).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ...compiler import CompiledScene
from ..bounce import BounceOut
from ..intersect import (
    BROADCAST_LIMIT,
    any_sequential,
    closest_sequential,
    gather_material,
    winner_attributes,
)
from ..v3 import V3

ENABLED = True
INTERPRET = False
# rays per program: one 1-D lane block, a power of two as Triton requires
BLOCK = 256
NUM_WARPS = 4


def _target_platform() -> str:
    """Platform the computation being traced is placed on: the scoped
    default device (a renderer's ``device=``) or the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def use_kernel(cs: CompiledScene) -> bool:
    """Whether the bounce of this scene runs in the fused kernel."""
    if cs.bvh is not None:
        return False
    if cs.n_planes + cs.n_spheres + cs.n_quads + cs.n_triangles > BROADCAST_LIMIT:
        return False
    return INTERPRET or _target_platform() == "gpu"


class _Col:
    """One scene table column inside the kernel: ``col[i]`` loads
    ``table[offset + i]`` (scalar ``i``: one load; index array: a gather)."""

    def __init__(self, ref, offset: int, length: int):
        self.ref, self.offset, self.shape = ref, offset, (length,)

    def __getitem__(self, i):
        return self.ref[self.offset + i]


def _scene_tables(cs: CompiledScene):
    """The fields a bounce reads, as one flat float32 table padded to a
    power of two, plus the pytree structure and column offsets to rebuild
    them as views.  Integer fields (texture ids) are small and exact in
    float32."""
    fields = (cs.planes, cs.spheres, cs.quads, cs.triangles, cs.materials,
              cs.lights)
    leaves, treedef = jax.tree.flatten(fields)
    cols, offsets, off = [], [], 0
    for leaf in leaves:
        leaf = jnp.asarray(leaf, jnp.float32).reshape(-1)
        cols.append(leaf)
        offsets.append((off, int(leaf.shape[0])))
        off += int(leaf.shape[0])
    size = 1 << max(0, math.ceil(math.log2(max(off, 1))))
    table = jnp.concatenate(cols + [jnp.zeros((size - off,), jnp.float32)])
    return table, treedef, tuple(offsets)


def _view(cs: CompiledScene, table_ref, treedef, offsets) -> CompiledScene:
    planes, spheres, quads, triangles, materials, lights = jax.tree.unflatten(
        treedef, [_Col(table_ref, o, n) for o, n in offsets]
    )
    return cs._replace(planes=planes, spheres=spheres, quads=quads,
                       triangles=triangles, materials=materials, lights=lights)


def _sweep_hit(cs, ro, rd, t_min, t_max):
    best_idx, best_t, hit = closest_sequential(cs, ro, rd, t_min, t_max)
    return winner_attributes(cs, ro, rd, best_idx, best_t, hit)


def _material(cs, prim):
    return gather_material(cs.materials, prim)


# output order of the kernel's flat f32 record
_OUT_FIELDS = ("hit", "killed", "w_sky", "w_nee", "rr_scale", "s_thr", "t_thr",
               "ox", "oy", "oz", "dx", "dy", "dz", "u", "v", "tex_id",
               "mr", "mg", "mb")


def _kernel(cs, treedef, offsets, shadow_tmax, table_ref,
            ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            tx_ref, ty_ref, tz_ref, key_ref, depth_ref, *out_refs):
    from ...models.path_tracer import _bounce_xla

    view = _view(cs, table_ref, treedef, offsets)
    out = _bounce_xla(
        view,
        V3(ox_ref[...], oy_ref[...], oz_ref[...]),
        V3(dx_ref[...], dy_ref[...], dz_ref[...]),
        V3(tx_ref[...], ty_ref[...], tz_ref[...]),
        key_ref[...], depth_ref[...], shadow_tmax=shadow_tmax,
        hit_fn=_sweep_hit, any_fn=any_sequential, mat_fn=_material,
    )
    vals = (out.hit, out.killed, out.w_sky, out.w_nee, out.rr_scale,
            out.s_thr, out.t_thr, *out.new_org, *out.new_dir, out.u, out.v,
            out.tex_id, *out.mat_color)
    for ref, val in zip(out_refs, vals):
        ref[...] = jnp.broadcast_to(val, ref.shape).astype(jnp.float32)


def path_bounce(cs: CompiledScene, ro: V3, rd: V3, thr: V3, key, depth,
                shadow_tmax: str = "reference") -> BounceOut:
    """One bounce of every ray in the fused kernel; same contract as
    ``models.path_tracer._bounce_xla``.  Any lane count: the wrapper pads
    to a whole number of blocks and slices the record back."""
    n = int(ro.x.shape[0])
    padded = -(-n // BLOCK) * BLOCK
    depth = jnp.broadcast_to(jnp.asarray(depth, jnp.int32), (n,))
    lanes = (*ro, *rd, *thr, jnp.asarray(key, jnp.uint32), depth)
    if padded != n:
        lanes = tuple(jnp.pad(a, (0, padded - n)) for a in lanes)
    table, treedef, offsets = _scene_tables(cs)

    block = pl.BlockSpec((BLOCK,), lambda i: (i,))
    interpret = INTERPRET and _target_platform() != "gpu"
    outs = pl.pallas_call(
        partial(_kernel, cs, treedef, offsets, shadow_tmax),
        grid=(padded // BLOCK,),
        in_specs=[pl.BlockSpec(table.shape, lambda i: (0,))] + [block] * 11,
        out_specs=[block] * len(_OUT_FIELDS),
        out_shape=[jax.ShapeDtypeStruct((padded,), jnp.float32)] * len(_OUT_FIELDS),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="path_bounce",
    )(table, *lanes)
    r = dict(zip(_OUT_FIELDS, (o[:n] for o in outs)))
    return BounceOut(
        hit=r["hit"] > 0.5,
        killed=r["killed"] > 0.5,
        w_sky=r["w_sky"],
        w_nee=r["w_nee"],
        rr_scale=r["rr_scale"],
        s_thr=r["s_thr"],
        t_thr=r["t_thr"],
        new_org=V3(r["ox"], r["oy"], r["oz"]),
        new_dir=V3(r["dx"], r["dy"], r["dz"]),
        u=r["u"],
        v=r["v"],
        tex_id=r["tex_id"],
        mat_color=V3(r["mr"], r["mg"], r["mb"]),
    )
