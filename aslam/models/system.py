"""SLAM system facade: tracking + local mapping (+ loop closing).

Replaces the reference driver wiring (main.cpp:25-143): constructs the
subsystems, feeds frames, exports trajectories.  Where the reference spawns
pthreads (main.cpp:79-85), this engine interleaves jitted stages on the
host thread — JAX's async dispatch overlaps device work with host
orchestration, and every map update is a pure function, so the 19 mutexes
of the reference have no equivalent here.
"""

from __future__ import annotations

import numpy as np

from aslam.config import SystemConfig
from aslam.models.localmapping import LocalMapping
from aslam.models.tracking import Tracking
from aslam.utils import trajectory


class SlamSystem:
    def __init__(self, cfg: SystemConfig | None = None, seed: int = 0):
        self.cfg = cfg or SystemConfig()
        self.tracking = Tracking(self.cfg, seed=seed)
        self.local_mapping = LocalMapping(self.cfg)
        self.loop_closing = None
        if self.cfg.use_loop_closing:
            from aslam.models.loopclosing import LoopClosing

            self.loop_closing = LoopClosing(self.cfg)
            self.tracking.relocalizer = self.loop_closing

    def process(self, img: np.ndarray, depth: np.ndarray, t: float = 0.0):
        if self.tracking.state == "NEW_SEQUENCE":
            return self._anchor_new_sequence(img, depth, t)
        T, info = self.tracking.track(img, depth, t)
        if info.get("new_kf"):
            slot = self.tracking.new_kf_slots[-1]
            kf_id = self.tracking.kf_counter - 1
            self.tracking.map = self.local_mapping.process_keyframe(
                self.tracking.map, slot, kf_id, self.tracking.n_kfs
            )
            if self.loop_closing is not None:
                self.tracking.map = self.loop_closing.process_keyframe(
                    self.tracking.map, slot, kf_id
                )
            # local BA / loop correction moved the reference KF: refresh
            # the tracker's copy so the keyframe-trigger distance and the
            # recorded relative poses T_cr are measured against the KF's
            # CURRENT pose (the reference reads mpReferenceKF->GetPose()
            # fresh per frame, tracking.cpp:544-582)
            self.tracking.last_kf_T = np.asarray(
                self.tracking.map.kf_T_cw[slot])
        return T, info

    def new_sequence(self) -> None:
        """Start a new input sequence into the SAME map (multi-sequence
        mapping, BASELINE config 5).  Tracking state resets; the first
        frame of the new sequence is anchored by relocalization against
        the existing map (if loop closing / vocabulary is available),
        otherwise it continues from the last pose."""
        t = self.tracking
        t.last_frame = None
        t.last_assoc = None
        t.state = "NEW_SEQUENCE"

    def _anchor_new_sequence(self, img, depth, t_stamp):
        import jax.numpy as jnp

        from aslam.models import frame as frame_mod

        tr = self.tracking
        frame, tr.adaptive = frame_mod.make_frame(
            np.asarray(img, np.float32), np.asarray(depth, np.float32),
            self.cfg, tr.adaptive)
        T0 = None
        if self.loop_closing is not None:
            T0 = self.loop_closing.relocalize(tr.map, frame)
        if T0 is None:
            T0 = tr.last_kf_T if tr.last_kf_T is not None else np.eye(4)
        frame = frame_mod.with_pose(frame, jnp.asarray(T0))
        # bootstrap landmark bindings from the existing map so tracking
        # has a covisibility seed (no prior associations exist yet)
        from aslam.models.tracking import bootstrap_track

        T_b, assoc, n_b = bootstrap_track(tr.map, frame, self.cfg)
        if int(n_b) >= 10:
            frame = frame_mod.with_pose(frame, T_b)
        tr.last_frame = frame
        tr.last_assoc = assoc
        tr.state = "OK"
        tr.poses.append(np.asarray(frame.T_cw))
        tr.timestamps.append(t_stamp)
        tr.stats.append({"new_sequence": True})
        tr.record_relative_pose(np.asarray(frame.T_cw))
        return np.asarray(frame.T_cw), {"new_sequence": True,
                                        "relocalized": T0 is not None}

    # -- exports (main.cpp:124-126) -----------------------------------
    def rebuilt_trajectory(self) -> np.ndarray:
        """Full camera trajectory rebuilt from the FINAL keyframe poses:
        T_cw(t) = T_cr(t) @ T_rw(final), walking the culled-KF parent chain
        to a surviving ancestor when the reference KF is gone.  This is the
        reference's SaveTrajectory semantics (tracking.cpp:544-582): local
        BA, keyframe culling, and loop corrections all propagate into the
        exported trajectory retroactively."""
        tr = self.tracking
        m = tr.map
        kf_valid = np.asarray(m.kf_valid)
        kf_ids = np.asarray(m.kf_id)
        kf_T = np.asarray(m.kf_T_cw)
        id2slot = {int(i): s for s, i in enumerate(kf_ids) if kf_valid[s]}
        culled = self.local_mapping.culled
        out = []
        for i, (ref, T_cr) in enumerate(zip(tr.ref_kf_ids, tr.rel_poses)):
            T_acc = T_cr
            r = ref
            hops = 0
            while r not in id2slot and r in culled and hops < len(culled) + 1:
                parent, T_rp = culled[r]
                T_acc = T_acc @ T_rp
                r = parent
                hops += 1
            if r in id2slot:
                out.append(T_acc @ kf_T[id2slot[r]])
            else:  # no surviving ancestor: keep the frozen track-time pose
                out.append(tr.poses[i])
        return np.stack(out)

    def save_trajectory(self, path: str, corrected: bool = True) -> None:
        poses = (
            self.rebuilt_trajectory()
            if corrected and self.tracking.rel_poses
            else np.stack(self.tracking.poses)
        )
        trajectory.save_tum_trajectory(
            path, np.asarray(self.tracking.timestamps), poses,
        )

    def save_keyframe_trajectory(self, path: str) -> None:
        m = self.tracking.map
        valid = np.asarray(m.kf_valid)
        poses = np.asarray(m.kf_T_cw)[valid]
        ids = np.asarray(m.kf_id)[valid]
        order = np.argsort(ids)
        trajectory.save_tum_trajectory(
            path, ids[order].astype(np.float64), poses[order]
        )

    def save_observation_histogram(self, path: str) -> None:
        """Histogram of per-landmark observation counts
        (SaveObservationHistogram, tracking.cpp:609-631 writes
        Histogram.csv)."""
        from aslam.models import mapstate as ms

        obs = np.asarray(ms.observation_counts(self.tracking.map))
        valid = np.asarray(self.tracking.map.lm_valid)
        counts = np.bincount(obs[valid], minlength=1)
        with open(path, "w") as f:
            f.write("n_observations,n_landmarks\n")
            for n, c in enumerate(counts):
                f.write(f"{n},{int(c)}\n")

    @property
    def map(self):
        return self.tracking.map
