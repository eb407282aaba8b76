"""Image pyramid + Gaussian blur.

Replaces `ORBextractor::ComputePyramid` (reference orbextractor.cpp:833-857:
8 levels, successive 1/1.2 bilinear resize) and the pre-descriptor
`GaussianBlur(7x7, sigma=2)` (orbextractor.cpp:795-800).

Everything runs as dense XLA ops (resize = two fixed-point weight matmuls,
blur = separable shifted-slice accumulation) which XLA fuses.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def level_shape(height: int, width: int, scale_factor: float, level: int) -> tuple[int, int]:
    inv = 1.0 / (scale_factor ** level)
    return max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)


# fixed-point bits of the resize weights (the reference's cv::resize uses 11)
RESIZE_SHIFT = 12


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize's antialiased 'linear'
    kernel for a downscale, in fixed point: integers summing to
    2**RESIZE_SHIFT in every row."""
    s = n_out / n_in
    sample = (np.arange(n_out) + 0.5) / s - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(n_in))
                   / max(1.0 / s, 1.0))
    w /= w.sum(axis=1, keepdims=True)
    q = np.round(w * 2**RESIZE_SHIFT)
    q[np.arange(n_out), q.argmax(axis=1)] += 2**RESIZE_SHIFT - q.sum(axis=1)
    return q.astype(np.float32)


def resize_integer(img: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Antialiased bilinear downscale to integer pixel values, like the
    reference's uint8 cv::resize.  On an integer-valued image every product
    and partial sum is an integer below 2**24, so the float32 matmuls are
    exact in any summation order: the result is bit-identical on every
    backend (a float resize differs in the last bits between CPU and GPU,
    which flips descriptor comparisons between pixels of flat regions)."""
    hi = jax.lax.Precision.HIGHEST
    wy = jnp.asarray(_resize_weights(img.shape[0], h))
    wx = jnp.asarray(_resize_weights(img.shape[1], w))
    t = jnp.round(jnp.dot(wy, img, precision=hi) * 2.0**-RESIZE_SHIFT)
    return jnp.round(jnp.dot(t, wx.T, precision=hi) * 2.0**-RESIZE_SHIFT)


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float) -> list[jnp.ndarray]:
    """img [H,W] float32 -> list of n_levels arrays, level l scaled by
    scale_factor^-l.  Successive resize from the previous level, matching the
    reference's cascade (orbextractor.cpp:843-853); levels >= 1 hold
    integer values."""
    H, W = img.shape
    levels = [img]
    for l in range(1, n_levels):
        h, w = level_shape(H, W, scale_factor, l)
        levels.append(resize_integer(levels[-1], h, w))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> tuple[float, ...]:
    half = ksize // 2
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-half, half + 1)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with edge replication, [H,W] -> [H,W]."""
    k = _gaussian_kernel(ksize, sigma)
    half = ksize // 2
    H, W = img.shape
    # static shifted-slice accumulation: 2*ksize fused elementwise FMAs
    # instead of a 1-channel spatial convolution
    x = jnp.pad(img, ((half, half), (0, 0)), mode="edge")
    y = jnp.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * jax.lax.slice(x, (i, 0), (i + H, W))
    x = jnp.pad(y, ((0, 0), (half, half)), mode="edge")
    y = jnp.zeros_like(img)
    for i in range(ksize):
        y = y + float(k[i]) * jax.lax.slice(x, (0, i), (H, i + W))
    return y
