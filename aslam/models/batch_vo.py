"""Batched visual odometry: B independent sequences per device program.

The sequence axis is the SLAM analog of batch data parallelism
(SURVEY.md §2.3: "sequence shards for multi-sequence maps").  For offline
processing — map building from recording fleets, dataset sweeps,
evaluation farms — a single chip tracks B sequences simultaneously by
vmapping the frame pipeline: one extraction + matching + RANSAC + BA
program over [B, H, W] image stacks, multiplying per-chip throughput
without touching the latency path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from aslam.config import SystemConfig
from aslam.models import frame as frame_mod
from aslam.models.extractor import init_adaptive_state
from aslam.models.odometry import rba_step


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def batch_frame(imgs, depths, grids, cfg: SystemConfig, height, width):
    """[B,H,W] x2 -> batched FrameData (vmapped extraction)."""
    return jax.vmap(
        lambda i, d, g: frame_mod._make_frame_impl(i, d, g, cfg, height, width)
    )(imgs, depths, grids)


@functools.partial(jax.jit, static_argnames=("cfg",))
def batch_rba(frames_prev, frames_cur, keys, cfg: SystemConfig):
    """Vmapped frame-to-frame odometry over the sequence batch."""
    return jax.vmap(lambda a, b, k: rba_step(a, b, k, cfg))(
        frames_prev, frames_cur, keys
    )


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def batch_track_sequence(prev_frames, imgs, depths, grids, keys,
                         cfg: SystemConfig, height, width):
    """vmap x scan: B sequences x T frames in ONE device program.

    imgs/depths [B,T,H,W], keys [B,T,2], prev_frames a batched FrameData,
    grids [B,g,g].  Composes the two throughput axes — the sequence batch
    (data parallelism) and the frame chain (dispatch amortization,
    models/odometry.track_sequence) — so a whole recording fleet's chunk
    runs per dispatch.  Returns (last frames, grids, SequenceResult with
    leading [B,T] axes)."""
    from aslam.models.odometry import track_sequence

    return jax.vmap(
        lambda f, im, de, g, k: track_sequence(
            f, im, de, g, k, cfg, height, width)
    )(prev_frames, imgs, depths, grids, keys)


class BatchVisualOdometry:
    """Track B sequences in lockstep; poses accumulate on device."""

    def __init__(self, cfg: SystemConfig, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        g = init_adaptive_state(cfg.extractor).grid_thresholds
        self.grids = jnp.tile(g[None], (batch, 1, 1))
        self.key = jax.random.PRNGKey(seed)
        self.prev = None
        self.pose_buf: list = []

    def process(self, imgs: np.ndarray, depths: np.ndarray):
        """imgs/depths: [B,H,W] (uint8/uint16/float ok)."""
        h, w = imgs.shape[1:]
        frames, self.grids = batch_frame(
            jnp.asarray(imgs), jnp.asarray(depths), self.grids,
            self.cfg, h, w)
        if self.prev is None:
            eye = jnp.tile(jnp.eye(4)[None], (self.batch, 1, 1))
            frames = frames._replace(T_cw=eye)
        else:
            self.key, sub = jax.random.split(self.key)
            keys = jax.random.split(sub, self.batch)
            res = batch_rba(self.prev, frames, keys, self.cfg)
            frames = frames._replace(T_cw=res.T_cw2)
            self.pose_buf.append(res.T_cw2)
        self.prev = frames
        return frames.T_cw

    def process_chunk(self, imgs: np.ndarray, depths: np.ndarray):
        """imgs/depths: [B,T,H,W] — the whole chunk in one dispatch
        (vmap x scan).  Same PRNG recurrence as T `process` calls
        (chained split -> per-batch split, reproduced on device by
        `_chunk_keys`); trajectories agree to sub-cm with the streaming
        path (bitwise equality is not guaranteed across differently-fused
        XLA programs — see test_batch_vo)."""
        start = 0
        if self.prev is None:
            self.process(imgs[:, 0], depths[:, 0])
            start = 1
        T = imgs.shape[1] - start
        if T <= 0:
            return self.prev.T_cw
        h, w = imgs.shape[2:]
        self.key, keys = _chunk_keys(self.key, T, self.batch)
        last, self.grids, seq = batch_track_sequence(
            self.prev, jnp.asarray(imgs[:, start:]),
            jnp.asarray(depths[:, start:]), self.grids,
            jnp.swapaxes(keys, 0, 1), self.cfg, h, w)
        self.prev = last
        Ts = jnp.swapaxes(seq.T_cw, 0, 1)  # [T,B,4,4]
        self.pose_buf.extend(Ts[t] for t in range(T))
        return last.T_cw

    def trajectories(self) -> np.ndarray:
        """[F-1, B, 4, 4] pose chain (one batched readback)."""
        return np.stack(jax.device_get(self.pose_buf))


@functools.partial(jax.jit, static_argnames=("T", "B"))
def _chunk_keys(key, T: int, B: int):
    """The streaming wrapper's per-frame key recurrence
    (key,sub = split(key); frame_keys = split(sub, B)) unrolled on device:
    returns (key', [T,B,2] keys)."""

    def step(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.split(sub, B)

    return jax.lax.scan(step, key, None, length=T)
