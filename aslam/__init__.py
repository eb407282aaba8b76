"""aslam — accelerator RGB-D SLAM engine in JAX/XLA.

A from-scratch re-design of the adaptive RGB-D localization & mapping
reference system (ORB-SLAM2-derived C++ pipeline, see SURVEY.md) for an
accelerator.  Instead of a pointer graph of mutex-guarded objects, the
world state is a pytree of fixed-capacity arrays; instead of sequential
per-keypoint loops, every hot op is a batched XLA computation; instead
of pthreads, pipeline concurrency is asynchronous device dispatch; instead of
OpenMP, parallelism is vmap; multi-device scaling is `jax.sharding.Mesh` +
`shard_map` with psum/all_gather collectives.

Layer map (mirrors SURVEY.md §1, re-architected):

    models/   pipeline state machines: Frame, MapState, Tracking, LocalMapping,
              LoopClosing, System        (replaces System/ Core/ LoopClosing/)
    ops/      batched compute kernels: pyramid, FAST, ORB, Hamming matching,
              RANSAC, ICP/GICP, bundle adjustment, BoW, pose graph
              (replaces Features/ Odometry/ + OpenCV/PCL/g2o/DBoW3)
    parallel/ mesh construction + sharded BA (new capability; reference is
              single-process)
    utils/    SE(3), camera models, datasets, trajectory IO, evaluation
              (replaces Utils/)
    native/   C++ runtime components (dataset prefetch/decode) with ctypes
              bindings (replaces the C++ driver-side IO)
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code multiplies pose matrices with world coordinates that can
# reach hundreds of meters; a reduced-precision f32 matmul (bf16 passes, or
# TF32 on tensor cores, ~2^-10 relative) injects meter-scale pose error at
# map scale (observed: global BA divergence on a 500 m corridor).  Force
# full f32 for f32 matmuls engine-wide; the Hamming matcher feeds explicit
# bf16 +-1 inputs with f32 accumulation and is exact regardless.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent XLA compilation cache.  The fused per-frame SLAM program takes
# tens of seconds to compile; with the cache, every later process loads the
# serialized executable instead.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives at
# a fixed path in the checkout (a path that moves never hits).
import os as _os

CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from aslam.config import (  # noqa: F401
    CameraModel,
    ExtractorConfig,
    MatcherConfig,
    RansacConfig,
    BAConfig,
    TrackingConfig,
    MapConfig,
    SystemConfig,
    TUM_FR1,
    TUM_FR2,
    TUM_FR3,
    ICL_NUIM,
)
