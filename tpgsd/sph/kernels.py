"""Smoothing kernels for SPH.

Each kernel provides ``w(r, h)`` and ``dw_over_r(r, h)`` (the radial
derivative divided by r, so the gradient is ``(x_i - x_j) * dw_over_r``
with no division by a possibly-zero r).  Support radius is ``2h`` for
both kernels; everything is elementwise jnp and safe inside Pallas
kernels, which pass their own correctly rounded ``div``.
"""

import math
import operator

import jax.numpy as jnp


class CubicSpline:
    """Monaghan cubic spline kernel, support radius 2h."""

    support_scale = 2.0

    @staticmethod
    def _sigma(h, dim=3):
        if dim == 3:
            return 1.0 / (math.pi * h**3)
        if dim == 2:
            return 10.0 / (7.0 * math.pi * h**2)
        return 2.0 / (3.0 * h)

    @classmethod
    def w(cls, r, h, dim=3, div=operator.truediv):
        q = div(r, h)
        sigma = cls._sigma(h, dim)
        w1 = 1.0 - 1.5 * q**2 + 0.75 * q**3
        w2 = 0.25 * (2.0 - q) ** 3
        return sigma * jnp.where(q < 1.0, w1, jnp.where(q < 2.0, w2, 0.0))

    @classmethod
    def dw_over_r(cls, r, h, dim=3, div=operator.truediv):
        """(1/r) dW/dr, finite at r=0."""
        q = div(r, h)
        sigma = cls._sigma(h, dim)
        # dW/dq / q, continuous at q=0
        g1 = -3.0 + 2.25 * q
        # (d/dq)(0.25 (2-q)^3) = -0.75 (2-q)^2 ; divided by q
        safe_q = jnp.maximum(q, 1e-12)
        g2 = div(-0.75 * (2.0 - q) ** 2, safe_q)
        g = jnp.where(q < 1.0, g1, jnp.where(q < 2.0, g2, 0.0))
        return div(sigma * g, h * h)


class WendlandC2:
    """Wendland C2 kernel (2-D / 3-D), support radius 2h - smoother
    spectra, resists pairing instability; the usual choice at scale."""

    support_scale = 2.0

    @staticmethod
    def _sigma(h, dim):
        if dim == 3:
            return 21.0 / (16.0 * math.pi * h**3)
        if dim == 2:
            return 7.0 / (4.0 * math.pi * h**2)
        raise ValueError("WendlandC2 supports dim 2 or 3, got %r" % (dim,))

    @classmethod
    def w(cls, r, h, dim=3, div=operator.truediv):
        q = div(r, h)
        sigma = cls._sigma(h, dim)
        t = jnp.maximum(1.0 - 0.5 * q, 0.0)
        return sigma * t**4 * (2.0 * q + 1.0)

    @classmethod
    def dw_over_r(cls, r, h, dim=3, div=operator.truediv):
        q = div(r, h)
        sigma = cls._sigma(h, dim)
        t = jnp.maximum(1.0 - 0.5 * q, 0.0)
        # dW/dq = sigma * (-5 q) * t^3 ; divide by q*h^2 -> no singularity
        return div(sigma * (-5.0) * t**3, h * h)
