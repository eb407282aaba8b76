"""Typed configuration for the whole engine.

The reference scatters its configuration over compile-time constants
(`Utils/common.h:32-77`, `main.cpp:17-23`, constructor literals at
`Odometry/odometry.cpp:13-30`, `Features/extractor.cpp:56-76`).  Here every
knob lives in one frozen-dataclass tree that is hashable, so configs can be
passed as static arguments to jitted functions.

Behavioral constants preserved from the reference (SURVEY.md §7.4):
  depth_factor 1/5000, bf 40, th_depth = bf*40/fx   (common.h:67-74)
  n_features 1000                                    (common.h:77)
  pyramid 8 levels x1.2, FAST threshold 20 -> 7      (extractor.cpp:86)
  adaptive grid 3x3, band 600..1020, x0.7/x1.3       (extractor.cpp:56-76)
  ratio tests 0.9 (frame-frame) / 0.8 (local map)    (tracking.cpp:197,401)
  Hamming TH_LOW 50 / TH_HIGH 100                    (matcher.cpp:16-17)
  RANSAC 200 iters / minInliers 20 / mahal 3.0 / k=4 (odometry.cpp:14)
  depth sigma 0.01 z^2 (Khoshelham)                  (ransac.cpp:423-431)
  chi2 5.991/7.815, Huber sqrt(chi2), info 1/z^2     (pnpsolver.cpp:51-75)
  BA schedules 4x10 (pose-only), 5+10 (local)        (pnpsolver.cpp:144, lba.cpp:213)
  KF trigger 0.15 m / 0.25 rad                       (tracking.cpp:451-452)
  covisibility edge >=15, local map <=80 KFs         (keyframe.cpp:165, tracking.cpp:307)
  culling found<0.25, obs<=3, redundancy 95%@3       (localmapping.cpp:122-236)
  loop minScore 0.06, 10 KF gap, 0.8/0.75 fractions  (loopclosing.cpp:68-75)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraModel:
    """Pinhole + radial-tangential camera, pseudo-stereo baseline.

    Replaces namespace `Calibration` (reference Utils/common.h:32-77).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    # radial-tangential distortion (k1 k2 p1 p2 k3)
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # depth image scaling: meters = raw * depth_factor  (common.h:67)
    depth_factor: float = 1.0 / 5000.0
    # pseudo-stereo baseline*fx product, u_right = u - bf/z  (common.h:70)
    bf: float = 40.0
    # horizontal/vertical FOV used by the RANSAC raster error model
    # (ransac.cpp:352-357)
    fov_x_deg: float = 58.0
    fov_y_deg: float = 45.0

    @property
    def th_depth(self) -> float:
        """Close/far landmark depth threshold (common.h:73: mbf*40/fx)."""
        return self.bf * 40.0 / self.fx

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


# Reference presets (common.h:34-64).
TUM_FR1 = CameraModel(
    fx=517.3, fy=516.5, cx=318.6, cy=255.3,
    k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
)
TUM_FR2 = CameraModel(fx=520.9, fy=521.0, cx=325.1, cy=249.7)
TUM_FR3 = CameraModel(fx=535.4, fy=539.2, cx=320.1, cy=247.6)
ICL_NUIM = CameraModel(fx=481.20, fy=-480.00, cx=319.50, cy=239.50)


@dataclass(frozen=True)
class ExtractorConfig:
    """ORB front-end (reference Features/, SURVEY.md components 11-16)."""

    n_features: int = 1000          # common.h:77
    n_levels: int = 8               # orbextractor 8-level pyramid
    scale_factor: float = 1.2
    fast_threshold: int = 20        # initial FAST threshold
    fast_threshold_min: int = 7     # per-cell fallback threshold
    # detector x descriptor enum algebra (reference extractor.h:8-25):
    # detector in {FAST, GFTT, HARRIS, DOG, HESSIAN, STAR} + aliases
    # {ORB, ORB_SLAM2, BRISK/AGAST->FAST, SIFT->DOG, SURF->HESSIAN, ...};
    # descriptor in {ORB, BRIEF, FREAK, LATCH, SIFT} + aliases
    # {ORB_SLAM2->ORB, BRISK->FREAK, SURF->SIFT}.  Defaults reproduce the
    # reference's ORB_SLAM2/ORB_SLAM2 main path (main.cpp:59).
    detector: str = "FAST"
    descriptor: str = "ORB"
    # grid cell size (pixels, level-local) used for spatially-uniform top-k;
    # reproduces the 30-px FAST cells + quad-tree distribution semantics
    # (orbextractor.cpp:466-746) as a bucketed top-k.
    cell_px: int = 32
    # per-cell candidate capacity for the bucketed top-k (the quad-tree
    # equivalent adapts depth; we oversample per cell instead)
    cell_topk: int = 8
    # padded keypoint capacity per frame (static shape for XLA)
    max_keypoints: int = 1024
    patch_radius: int = 15          # IC-angle / rBRIEF patch half-size
    # adaptive per-cell threshold controller (extractor.cpp:56-76,
    # detectoradjuster.cpp:42-54, videogrid* stack)
    adaptive: bool = True
    adaptive_grid: int = 3          # 3x3 cells
    adaptive_min: int = 600
    adaptive_max: int = 1020
    adaptive_iters: int = 5
    adaptive_down: float = 0.7      # tooFew  -> threshold *= 0.7
    adaptive_up: float = 1.3        # tooMany -> threshold *= 1.3
    adaptive_th_min: float = 2.0
    adaptive_th_max: float = 80.0
    # keypoint depth sampling window (odd; 1 = the reference's single-pixel
    # read, frame.cpp:148-164).  A robust k x k neighborhood mean (neighbors
    # gated to 3-sigma Khoshelham agreement with the center pixel so depth
    # edges are never averaged across) cuts the per-landmark depth noise by
    # ~sqrt(valid neighbors) — landmark positions anchor the whole tracking
    # chain, so this directly shrinks map drift.
    depth_patch: int = 3

    def __post_init__(self):
        if self.depth_patch < 1 or self.depth_patch % 2 == 0:
            raise ValueError(
                f"depth_patch must be odd and >= 1, got {self.depth_patch} "
                "(an even value would silently degrade to the single-pixel "
                "read via r = (k-1)//2)")

    @property
    def scale_factors(self) -> tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    @property
    def features_per_level(self) -> tuple[int, ...]:
        """Geometric allocation of n_features over levels (ORB-SLAM2 scheme)."""
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1.0 - inv) / (1.0 - inv ** self.n_levels)
        counts = []
        acc = 0
        for _ in range(self.n_levels - 1):
            c = int(round(n_desired))
            counts.append(c)
            acc += c
            n_desired *= inv
        counts.append(max(self.n_features - acc, 0))
        return tuple(counts)


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference Features/matcher.{h,cpp})."""

    th_low: int = 50                # matcher.cpp:16
    th_high: int = 100              # matcher.cpp:17
    ratio_frame: float = 0.9        # tracking.cpp:197 (frame-to-frame knn)
    ratio_local: float = 0.8        # tracking.cpp:401 (projection match)
    ratio_bow: float = 0.6          # matcher.h:12
    proj_radius: float = 8.0        # tracking.cpp:402 search window radius
    fuse_radius: float = 4.0        # localmapping.cpp:160 fuse radius


@dataclass(frozen=True)
class RansacConfig:
    """Mahalanobis 3D-3D RANSAC (reference Odometry/ransac.{h,cpp}).

    The reference runs 200 sequential hypotheses with up to 20 refinement
    steps and data-dependent early exit (ransac.cpp:87-136).  Batched, we
    score `n_hypotheses` in parallel with a fixed `refine_iters` refinement
    schedule; more parallel hypotheses replace early exit.
    """

    n_hypotheses: int = 256
    refine_iters: int = 8
    min_inliers: int = 20           # odometry.cpp:14
    max_mahalanobis: float = 3.0
    sample_size: int = 4
    # match-pool capacity (padded, static shape)
    max_matches: int = 1024
    # Khoshelham depth noise: sigma_z = c * z^2  (ransac.cpp:423-431)
    depth_std_c: float = 0.01


@dataclass(frozen=True)
class ICPConfig:
    """GICP refinement (reference Odometry/generalizedicp.{h,cpp})."""

    iterations: int = 10            # generalizedicp.cpp:11
    max_corr_dist: float = 0.07
    # adaptive escalation thresholds (odometry.cpp:52-66)
    escalate_min_inliers: int = 20
    escalate_rmse: float = 0.7      # rmse*10 >= 7
    restart_rmse: float = 2.0       # rmse*10 >= 20 -> identity warm start
    # refinement model: "gicp" = plane-to-plane with per-point covariances
    # C = R diag(eps,1,1) R^T (pcl::GeneralizedICP, generalizedicp.h:41);
    # "point_to_plane" = the simpler nT(p-q) residual
    method: str = "gicp"
    gicp_epsilon: float = 1e-3      # covariance thickness along the normal


@dataclass(frozen=True)
class BAConfig:
    """Bundle-adjustment schedules (reference Odometry/pnpsolver.cpp,
    localbundleadjustment.cpp, globalbundleadjustment.cpp)."""

    # motion-only BA: 4 rounds x 10 iterations, chi2 reclassification in
    # between, robust kernel dropped after round 3 (pnpsolver.cpp:144-205)
    pose_rounds: int = 4
    pose_iters: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # local BA: 5 iters -> outlier prune -> 10 iters (lba.cpp:213-255)
    local_iters_1: int = 5
    local_iters_2: int = 10
    # LM damping
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    # measurement information model for reprojection residuals:
    #   "inv_z2"   — I/z² (the reference's choice, pnpsolver.cpp:74-75)
    #   "constant" — identity (pixel noise is ~constant in pixels; this is
    #                what ORB-SLAM2's per-octave invSigma2 reduces to at a
    #                single scale, and it avoids 1/z² letting the few
    #                closest landmarks dominate the normal equations)
    info_model: str = "inv_z2"
    # information of the odometry-chain regularizer between temporally
    # consecutive window cameras in local BA (ops/lba.ChainSpec): keeps
    # the window solution consistent with the tracked relative motion
    # instead of letting correlated landmark depth noise shear the KF
    # chain (r3 loop-scene diagnosis: the rebuilt-from-KF trajectory lost
    # to the live one without it).  1/m^2 for the translation block; 0
    # restores the reference's reprojection-only window.
    chain_prior_weight: float = 2.5e5
    # chain edges only bind window cams that are temporally CLOSE
    # (kf_id gap <= chain_max_gap; gaps of a few ids arise from keyframe
    # culling between surviving temporal neighbors).  Covisibility
    # neighbors from a revisit are temporally far apart — a full-weight
    # chain edge there would pin old-map vs new-map segments together at
    # the drifted relative estimate, exactly where reprojection evidence
    # should pull the revisit into alignment.
    chain_max_gap: int = 4
    # local-BA padded capacities (static shapes).  max_window_points is the
    # COMPACT landmark index space of the window problem — the Schur
    # coupling tensor is [C, max_window_points, 6, 3], independent of the
    # map's total landmark capacity.
    max_window_cams: int = 64
    max_fixed_cams: int = 64
    max_window_points: int = 4096
    max_edges: int = 16384


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end policy (reference System/tracking.cpp)."""

    kf_min_trans: float = 0.15      # tracking.cpp:451
    kf_min_rot: float = 0.25       # tracking.cpp:452
    max_vo_points: int = 100        # tracking.cpp:488-535 (<=100 close pts)
    local_map_max_kfs: int = 80     # tracking.cpp:307
    # one-hop covisibility expansion of the voted local-KF set before the
    # cap truncation (the reference's neighbors/children/parent expansion,
    # tracking.cpp:308-346)
    local_map_expand: bool = True
    min_matches_tracked: int = 20
    # information of the odometry motion prior fused into the local-map
    # pose refinement (ops/ba.pose_only_ba prior edge), in 1/m^2 for the
    # translation block (rotation block 4x stiffer).  0 restores the
    # reference's unconstrained reprojection-only re-solve.  2e6 ~= a
    # 0.7 mm translation sigma — the measured per-frame confidence of the
    # RANSAC+motion-BA odometry on the hard suite; map evidence overcomes
    # it exactly when it is persistent (revisit drift), not when it is
    # single-view landmark noise (r3 loop-scene diagnosis).
    pose_prior_weight: float = 2.0e6
    # LOST-state pose policy when no relocalizer is available (the
    # reference declares LOST and does nothing, tracking.h:37):
    # "integrate" keeps the raw estimate (reference-faithful drift),
    # "motion_model" substitutes constant-velocity extrapolation so a
    # garbage estimate cannot poison the trajectory
    lost_policy: str = "motion_model"


@dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map arrays (replaces Core/ pointer graph)."""

    max_keyframes: int = 256
    max_landmarks: int = 32768
    # capacity of the per-landmark observer reverse index (mapstate
    # lm_obs_*): (kf, feat) pairs kept per landmark; appended at binding,
    # ring-overwritten past the cap (covisibility weights undercount for
    # landmarks observed by more than this many KFs — rare, and the
    # entries lost are the OLDEST observers)
    max_obs_per_lm: int = 16
    # capacity of the compacted candidate set fed to guided projection
    # matching (track-local-map / fuse).  The [cap, M] distance matrix
    # replaces a [max_landmarks, M] one — per-frame matching cost is
    # bounded by the local map's visible landmarks, not the global table.
    proj_match_cap: int = 8192
    # KF-chunk size for the blocked covisibility product (memory ceiling
    # O(chunk * max_landmarks) instead of O(K * L))
    covis_chunk: int = 256
    # per-landmark observation bookkeeping derived from per-KF feature slots
    covis_min_weight: int = 15      # keyframe.cpp:165
    cull_found_ratio: float = 0.25  # localmapping.cpp:122
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.95  # localmapping.cpp:236
    # KF-culling candidate set = top covisible neighbors of the current KF
    # (the reference's scan set, localmapping.cpp:198), capped for static
    # shapes
    kf_cull_candidates: int = 32
    # housekeeping cadence (device fast path): run landmark culling /
    # keyframe culling on every Nth keyframe insertion instead of every
    # one.  1 = reference cadence; the reference itself executes these
    # with queue latency when mapping lags (localmapping.cpp:35-49), so a
    # small N trades bounded staleness for per-KF cost.
    lm_cull_every: int = 1
    kf_cull_every: int = 1
    kf_cull_rounds: int = 3
    # run the windowed local BA on every Nth keyframe insertion (1 =
    # reference cadence).  The reference's mbAbortBA achieves the same
    # effect implicitly under load: BA is interrupted whenever a new KF
    # arrives, so a busy mapper refines every few KFs
    # (localmapping.cpp:241-246,321)
    lba_every: int = 1
    # full-map landmark position refresh every Nth keyframe (on top of the
    # per-KF touched-ids refresh): the global pass re-anchors EVERY
    # landmark to its observers' current poses, continuously propagating
    # LBA/pose-graph motion into the landmark field — measurably
    # load-bearing for long-session consistency (r5 session A/B).  Cost is
    # two [K,M]-wide passes (~2 ms at 1k KFs, ~70 ms at 8k), amortized N-fold.
    global_refresh_every: int = 4
    # windowed Schur local BA at each KF insertion (localmapping.cpp:45-48).
    # Off = tracking + landmark bookkeeping only (ablations; odometry-grade
    # maps where chain-local consistency matters more than reprojection
    # minimization)
    enable_local_ba: bool = True
    # closed-form multi-view landmark position refresh at each KF insertion
    # (information-weighted mean of all observing KFs' backprojections with
    # a 3-sigma trimmed second pass; mapstate.refresh_landmark_positions).
    # n observations cut the dominant depth-noise error ~sqrt(n); the
    # reference gets the same effect only implicitly through g2o local BA.
    refresh_positions: bool = True


@dataclass(frozen=True)
class LoopConfig:
    """Place recognition + loop closing (reference Core/keyframedatabase.cpp,
    LoopClosing/loopclosing.cpp; correction designed here — the reference
    never finished it, loopclosing.cpp:95-131)."""

    # 10^4 words: the vocabulary study (docs/VOCAB_STUDY.md) measured loop
    # average precision 0.39 at 10^4 vs 0.26 at 10^3 on ground-truth
    # revisits (the reference loads a ~10^6-word DBoW3 artifact absent from
    # its repo, main.cpp:67)
    vocab_branching: int = 10
    vocab_depth: int = 4
    min_score: float = 0.06         # loopclosing.cpp:75
    min_kf_gap: int = 10            # loopclosing.cpp:68
    word_fraction: float = 0.8      # keyframedatabase.cpp:87
    score_fraction: float = 0.75    # keyframedatabase.cpp:129
    pose_graph_iters: int = 20
    # global BA after a loop correction (the reference's staged
    # mTcwGBA/mPosGBA machinery exists precisely for a post-loop full BA
    # pass, globalbundleadjustment.cpp:154-190; it was never wired live).
    # 0 disables; the pose graph leaves a seam at the loop ends that a few
    # joint GN iterations close.
    post_gba_iters: int = 8
    post_gba_method: str = "gn_cg"
    # correction discrepancy gate: a geometrically VERIFIED loop whose
    # measured transform already agrees with the current estimate within
    # these bounds has no drift to correct — record the consistent
    # revisit, skip the pose-graph + GBA pass.  In revisit-heavy sessions
    # (every-frame keyframes in one room) verified "loops" fire every few
    # seconds; running a whole-map correction for a no-op residual dozens
    # of times accumulates solver noise instead of removing drift
    # (r3 scale-rehearsal diagnosis).
    min_correction_t: float = 0.03   # meters
    min_correction_r: float = 0.03   # radians
    # temporal-consistency gate (the ConsistentGroup design the reference
    # declares but never finishes, loopclosing.h:16-22; ORB-SLAM2's
    # mnCovisibilityConsistencyTh): a loop candidate is only verified after
    # its covisibility group was detected in `consistency_th` CONSECUTIVE
    # keyframes.  1 disables the gate (verify immediately).
    consistency_th: int = 3
    # verify the top-N database candidates, not just the argmax
    top_candidates: int = 3
    # load the shipped pretrained vocabulary artifact (aslam/assets/,
    # scripts/train_vocab.py) instead of training in-run on the first
    # keyframes.  Default OFF, data-backed (docs/VOCAB_STUDY.md): on the
    # procedural hard-synthetic suite a cross-scene vocabulary scores
    # AP 0.06 vs 0.39 for same-scene in-run training — the synthetic
    # textures are scene-idiosyncratic, unlike real imagery where a
    # generic vocabulary (the reference's ~100 MB DBoW3 artifact,
    # main.cpp:67) transfers.  Real-sensor deployments should turn this
    # on with an artifact trained on in-domain imagery.
    use_pretrained_vocab: bool = False
    # BoW-guided matching buckets by ancestor tree nodes this many levels
    # above the leaf (the reference's FeatureVector uses level-up-4 nodes of
    # a 6-level DBoW3 tree, frame.cpp:187; 0 = exact leaf equality, which
    # is over-strict — a one-bit descriptor change can flip the leaf)
    match_node_levels: int = 1
    # localized correction window (r4, VERDICT #2): anchor the loop
    # CANDIDATE's old-side covisibility group (members no newer than the
    # candidate) in the pose graph, so the trusted old-map segment stays
    # put and the correction distributes over the drifted recent segment
    # only — instead of smearing it over the whole session (where it
    # roughly cancelled the drift removal, docs/SCALE_SLAM.md r3).
    localized_window: bool = True
    # covisibility-proportional information on pose-graph edges
    # (w = clip(covis / covis_min_weight, 0, 4) instead of uniform 1.0).
    # ON by default since r5: the 4-config x 3-seed session ablation
    # (docs/LOOP_ABLATION.md) measured localized+covw as the ONLY
    # configuration with session ATE below loop-off (0.172 vs 0.232 m
    # mean; never worse on any seed), while localized-with-uniform-edges
    # let one seed's corrections blow up 0.30 -> 0.47 m.  (r3 had flagged
    # covw as risky with the GLOBAL window; combined with the localized
    # window the strong-covisibility weighting is what keeps a marginal
    # loop edge from shearing the anchored segment.)
    covis_weighted_edges: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for distributed BA (new capability; §2.3)."""

    kf_axis: int = 1                # shards of the reduced camera system
    lm_axis: int = 1                # landmark shards


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraModel = TUM_FR1
    extractor: ExtractorConfig = ExtractorConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    icp: ICPConfig = ICPConfig()
    ba: BAConfig = BAConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    loop: LoopConfig = LoopConfig()
    mesh: MeshConfig = MeshConfig()
    use_gicp: bool = False          # config 3 turns this on
    use_loop_closing: bool = False

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def small_config() -> SystemConfig:
    """A reduced-capacity config for unit tests (fast CPU compiles)."""
    return SystemConfig(
        camera=CameraModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                           width=320, height=240),
        extractor=ExtractorConfig(n_features=256, max_keypoints=256,
                                  n_levels=4),
        ransac=RansacConfig(n_hypotheses=64, refine_iters=4, max_matches=256),
        ba=BAConfig(max_window_cams=8, max_fixed_cams=8,
                    max_window_points=512, max_edges=1024),
        map=MapConfig(max_keyframes=32, max_landmarks=2048),
        loop=LoopConfig(vocab_branching=10, vocab_depth=3),
    )
