"""Map checkpoint / resume.

The reference has **no** persistence at all (SURVEY.md §5: map not
serializable, only end-of-run trajectory exports).  Long multi-sequence
runs (BASELINE config 5) need resume, so MapState — being a flat pytree of
arrays — serializes losslessly to one compressed npz plus a small JSON
sidecar of host counters.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from aslam.models.mapstate import MapState

_META_SUFFIX = ".meta.json"


def save_map(path: str, m: MapState, counters: dict | None = None) -> None:
    arrays = {f: np.asarray(getattr(m, f)) for f in m._fields
              if getattr(m, f) is not None}
    np.savez_compressed(path, **arrays)
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(counters or {}, f)


def load_map(path: str) -> tuple[MapState, dict]:
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path)
    fields = {f: jnp.asarray(data[f]) for f in MapState._fields if f in data}
    # pre-r5 checkpoints lack the observer reverse index — rebuild it from
    # kf_lm (the source of truth) host-side, oldest KF first so the ring
    # keeps the newest observers on overflow
    if "lm_obs_kf" not in fields:
        kf_lm = np.asarray(data["kf_lm"])
        kf_valid = np.asarray(data["kf_valid"])
        kf_id = np.asarray(data["kf_id"])
        L = int(np.asarray(data["lm_pos"]).shape[0])
        O = 16
        okf = np.full((L, O), -1, np.int32)
        ofe = np.zeros((L, O), np.int32)
        ptr = np.zeros(L, np.int32)
        for k in np.argsort(kf_id):
            if not kf_valid[k]:
                continue
            feats = np.nonzero(kf_lm[k] >= 0)[0]
            ls = kf_lm[k][feats]
            pos = ptr[ls] % O
            okf[ls, pos] = k
            ofe[ls, pos] = feats
            ptr[ls] += 1
        fields["lm_obs_kf"] = jnp.asarray(okf)
        fields["lm_obs_feat"] = jnp.asarray(ofe)
        fields["lm_obs_ptr"] = jnp.asarray(ptr)
    m = MapState(**fields)
    meta_path = path.removesuffix(".npz") + ".npz" + _META_SUFFIX
    counters = {}
    for candidate in (path + _META_SUFFIX, meta_path,
                      path.removesuffix(".npz") + _META_SUFFIX):
        if os.path.exists(candidate):
            with open(candidate) as f:
                counters = json.load(f)
            break
    return m, counters


def save_system(path_prefix: str, slam) -> None:
    """Persist a SlamSystem: map + tracking counters, and (when loop
    closing is active) the trained vocabulary + BoW database."""
    t = slam.tracking
    save_map(path_prefix, t.map, {
        "n_kfs": t.n_kfs,
        "next_lm": t.next_lm,
        "kf_counter": t.kf_counter,
        "state": t.state,
        "last_loop_kf_id": getattr(slam.loop_closing, "last_loop_kf_id", None)
        if slam.loop_closing else None,
        "vocab_trained_on_kfs": getattr(
            slam.loop_closing, "trained_on_kfs", None)
        if slam.loop_closing else None,
    })
    lc = slam.loop_closing
    if lc is not None and lc.vocab is not None:
        from aslam.ops import bow

        base = path_prefix.removesuffix(".npz")
        bow.save_vocabulary(base + ".vocab.npz", lc.vocab)
        np.savez_compressed(
            base + ".loopdb.npz",
            **{f: np.asarray(getattr(lc.db, f)) for f in lc.db._fields},
        )


def load_system(path_prefix: str, slam) -> None:
    m, counters = load_map(path_prefix)
    t = slam.tracking
    t.map = m
    t.n_kfs = counters.get("n_kfs", 0)
    t.next_lm = counters.get("next_lm", 0)
    t.kf_counter = counters.get("kf_counter", 0)
    state = counters.get("state", "NO_IMAGES")
    if state == "OK":
        # per-frame state (last frame/associations) is not persisted; the
        # next frame re-anchors against the restored map exactly like a
        # new sequence (relocalization + bootstrap_track)
        state = "NEW_SEQUENCE"
        if t.last_kf_T is None:
            import numpy as _np

            kf_valid = _np.asarray(m.kf_valid)
            if kf_valid.any():
                ids = _np.asarray(m.kf_id)
                last = _np.nonzero(kf_valid)[0][
                    _np.argmax(ids[kf_valid])
                ]
                t.last_kf_T = _np.asarray(m.kf_T_cw)[last]
    t.state = state

    lc = slam.loop_closing
    if lc is not None:
        import os as _os

        from aslam.models.loopclosing import DatabaseState
        from aslam.ops import bow

        base = path_prefix.removesuffix(".npz")
        if _os.path.exists(base + ".vocab.npz"):
            lc.vocab = bow.load_vocabulary(base + ".vocab.npz")
        if _os.path.exists(base + ".loopdb.npz"):
            data = np.load(base + ".loopdb.npz")
            lc.db = DatabaseState(**{
                f: jnp.asarray(data[f]) for f in DatabaseState._fields
            })
        if counters.get("last_loop_kf_id") is not None:
            lc.last_loop_kf_id = counters["last_loop_kf_id"]
        if counters.get("vocab_trained_on_kfs") is not None:
            lc.trained_on_kfs = counters["vocab_trained_on_kfs"]
