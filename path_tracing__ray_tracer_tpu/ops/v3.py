"""SoA 3-vectors: three separate arrays instead of a trailing dim of 3.

An ``(N, 3)`` array puts the short component axis minor, so every vector op
works on strided data.  Keeping x/y/z as independent ``(N,)`` arrays (the
classic structure-of-arrays layout the reference's CUDA kernels emulate
with scalar triples, e.g. ``cuda_renderer.py:115-261``) lets XLA lay every
component out densely and fuse all elementwise math.

``V3`` is a pytree (a ``NamedTuple``), so it passes through ``jit`` /
``lax.fori_loop`` carries transparently.  Components may be scalars or arrays;
all ops broadcast like ``jnp``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- construction -----------------------------------------------------
    @staticmethod
    def full(value, shape=()) -> "V3":
        a = jnp.full(shape, value, dtype=jnp.float32)
        return V3(a, a, a)

    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(
            jnp.asarray(x, jnp.float32),
            jnp.asarray(y, jnp.float32),
            jnp.asarray(z, jnp.float32),
        )

    @staticmethod
    def from_array(a) -> "V3":
        """From a trailing-dim-3 array (host/wire format) to SoA."""
        a = jnp.asarray(a, jnp.float32)
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):  # Hadamard
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "V3") -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self) -> jnp.ndarray:
        return self.dot(self)

    def norm(self) -> jnp.ndarray:
        return jnp.sqrt(self.norm2())

    def normalized(self, eps: float = 0.0) -> "V3":
        """Unit vector; matches the reference's guard (zero stays zero)."""
        n = self.norm()
        safe = jnp.where(n > eps, n, 1.0)
        scaled = self * (1.0 / safe)
        return V3.where(n > eps, scaled, V3.of(0.0, 0.0, 0.0))

    def reflect(self, n: "V3") -> "V3":
        """``v - 2 (v.n) n``."""
        return self - n * (2.0 * self.dot(n))

    # -- selection / reductions ---------------------------------------------
    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )

    def max_component(self) -> jnp.ndarray:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def luminance(self) -> jnp.ndarray:
        """Rec.601 luma, as used by the reference's Russian roulette
        (``cuda_path_tracer.py:308``)."""
        return 0.299 * self.x + 0.587 * self.y + 0.114 * self.z

    def astype(self, dtype) -> "V3":
        return V3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))

    def take(self, idx) -> "V3":
        """Gather components by index array."""
        return V3(
            jnp.take(self.x, idx, axis=0),
            jnp.take(self.y, idx, axis=0),
            jnp.take(self.z, idx, axis=0),
        )

    def at_index(self, i) -> "V3":
        """Dynamic scalar lookup (for ``fori_loop`` over primitives)."""
        return V3(self.x[i], self.y[i], self.z[i])


def refract(incident: V3, normal: V3, ni_over_nt) -> tuple[jnp.ndarray, V3]:
    """Branchless Snell refraction (semantics of ``cuda_texture_renderer.py:146-170``).

    Returns ``(refracted_mask, direction)``; where the mask is False the
    direction is unspecified (caller selects the TIR fallback).
    """
    cos_i = -incident.dot(normal)
    sin2_t = ni_over_nt * ni_over_nt * (1.0 - cos_i * cos_i)
    ok = sin2_t <= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    out = incident * ni_over_nt + normal * (ni_over_nt * cos_i - cos_t)
    return ok, out
