"""Counter-based stateless RNG for wavefront rendering.

The reference threads mutable per-thread RNG state through its megakernels
(LCG: ``cuda_renderer.py:74-78``; xorshift32: ``cuda_path_tracer.py:61-66``).
A wavefront renderer wants *stateless, counter-based* streams instead:
every random number is a pure function of (seed, pixel, sample, depth, use),
so passes can be reordered, sharded and resumed without carrying state.

We use the murmur3 finalizer (fmix32) as the mixing function: strong
avalanche and **fixed shift amounts only**, so the same few integer ops
run in XLA and inside the fused bounce kernel.  Unlike ``jax.random``'s
threefry this costs a handful of integer ops per number, cheap enough for
dozens of draws per bounce.  Distribution-level
(not bitwise) equivalence with the reference streams is the compatibility
target (SURVEY.md §7, "RNG fidelity").
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
# Odd 32-bit constants used to decorrelate key dimensions (golden-ratio based,
# standard PCG/SplitMix mixing constants).  NumPy scalars, so a Pallas kernel
# that draws numbers sees literals, not captured device arrays.
_GAMMA_DEPTH = np.uint32(0x9E3779B9)
_GAMMA_USE = np.uint32(0x85EBCA6B)


def pcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 fmix32: full-avalanche 32-bit mixer with fixed shifts.

    (Name kept from the original PCG-based implementation so call sites read
    generically as "the hash".)
    """
    # SplitMix-style increment first: fmix32(0) == 0, and an all-zero key
    # (pixel 0, sample 0, seed 0) must still produce a live stream
    h = x.astype(_U32) + jnp.uint32(0x9E3779B9)
    h = (h ^ (h >> jnp.uint32(16))) * jnp.uint32(0x85EBCA6B)
    h = (h ^ (h >> jnp.uint32(13))) * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> jnp.uint32(16))


def ray_key(seed, pixel_idx, sample_idx) -> jnp.ndarray:
    """Per-(pixel, sample) stream key. ``seed`` plays the role of the
    reference's ``frame_count`` reseed (``cuda_path_tracer.py:28``)."""
    s = jnp.asarray(seed).astype(_U32)
    p = jnp.asarray(pixel_idx).astype(_U32)
    k = pcg_hash(p ^ (s * _GAMMA_DEPTH))
    return pcg_hash(k + jnp.asarray(sample_idx).astype(_U32) * _GAMMA_USE)


def bits(key: jnp.ndarray, depth, use) -> jnp.ndarray:
    """Random uint32 for a (stream, depth, use) counter triple."""
    d = jnp.asarray(depth).astype(_U32)
    u = jnp.asarray(use).astype(_U32)
    return pcg_hash(pcg_hash(key ^ (d * _GAMMA_DEPTH)) + u * _GAMMA_USE)


def uniform(key: jnp.ndarray, depth, use) -> jnp.ndarray:
    """Uniform float32 in [0, 1) with 24-bit mantissa resolution
    (same resolution as the reference's ``cuda_random``:
    ``cuda_path_tracer.py:69-71``)."""
    return (bits(key, depth, use) >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0
    )
