"""A copy of ``boxmot_tpu/data/synth.py``.

Deterministic synthetic MOT sequence generator.

Produces MOT-Challenge-format sequences (seqinfo.ini + gt/gt.txt +
det/det.txt) with scripted lifecycle events so every tracker state
transition is reachable by tests and benchmarks without real data:

* stable anchors (long uninterrupted tracks),
* short dropouts (< track_buffer: lost -> re-found, same identity),
* long gaps (> track_buffer: track death + graveyard resurrection),
* late births with flicker (confirmation logic / min_hits),
* crossing pairs (occlusion + identity swap pressure),
* periodic low-confidence dips (byte-style second-stage association),
* clutter false positives.

The generator is pure numpy with a fixed seed: the same call always
writes byte-identical files.  Counterpart of the reference CI's
generate+eval fixtures (.github/workflows/ci.yml:211-247), redesigned as
a library so fixtures are synthesized rather than shipped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class SynthObject:
    """One scripted identity: linear motion plus jitter, with visibility
    governed by [start, end] spans (1-based, inclusive)."""

    track_id: int
    spans: list[tuple[int, int]]
    p0: tuple[float, float]
    v: tuple[float, float]
    size: tuple[float, float]
    conf: float = 0.9
    conf_dip_every: int = 0  # every k-th visible frame emits conf 0.3
    flicker_frames: tuple[int, ...] = ()  # det dropped on these frames

    def visible(self, frame: int) -> bool:
        return any(a <= frame <= b for a, b in self.spans)

    def box(self, frame: int, jitter: np.ndarray) -> np.ndarray:
        x = self.p0[0] + self.v[0] * (frame - 1) + jitter[0]
        y = self.p0[1] + self.v[1] * (frame - 1) + jitter[1]
        w, h = self.size
        return np.array([x, y, w, h], np.float64)


@dataclass
class SynthScenario:
    n_frames: int = 400
    im_width: int = 1280
    im_height: int = 720
    frame_rate: int = 30
    det_noise_px: float = 1.0
    clutter_per_frame: float = 0.6
    seed: int = 0
    objects: list[SynthObject] = field(default_factory=list)


def lifecycle_scenario(n_frames: int = 400, seed: int = 0) -> SynthScenario:
    """The default scripted scene: every lifecycle path is exercised."""
    F = n_frames
    objs = [
        # stable anchor, full length
        SynthObject(1, [(1, F)], (100, 100), (1.2, 0.6), (60, 120)),
        # short dropout: gap of 20 frames (< default track_buffer 30)
        SynthObject(2, [(1, 120), (141, F)], (400, 150), (0.8, 0.9), (55, 110),
                    conf_dip_every=7),
        # long gap: 120 frames (> track_buffer) -> death + rebirth
        SynthObject(3, [(1, 80), (200, F)], (700, 120), (-0.5, 1.0), (50, 100)),
        # late birth with flicker at start (confirmation pressure)
        SynthObject(4, [(60, F)], (200, 400), (1.5, -0.4), (45, 95),
                    flicker_frames=(61, 63, 66)),
        # crossing pair (occlusion around the midpoint)
        SynthObject(5, [(1, F)], (80, 300), (2.2, 0.1), (50, 105)),
        SynthObject(6, [(1, F)], (1000, 320), (-2.2, -0.1), (50, 105)),
        # leaves early
        SynthObject(7, [(1, 350)], (900, 500), (-0.6, -0.5), (65, 115)),
        # enters late
        SynthObject(8, [(250, F)], (150, 550), (1.8, -0.8), (48, 98)),
    ]
    return SynthScenario(n_frames=n_frames, seed=seed, objects=objs)


def mot17_scale_scenario(
    n_frames: int = 750,
    n_objects: int = 60,
    seed: int = 0,
    im_width: int = 1920,
    im_height: int = 1080,
    frame_rate: int = 30,
) -> SynthScenario:
    """A full-length, MOT17-density scene (pedestrian-flow statistics).

    MOT17 train sequences run 525-1500 frames with ~20-80 concurrent
    pedestrians (e.g. MOT17-04: 1050 frames / 1920x1080 / dense
    sidewalk).  This scenario reproduces that scale for the full-scale
    parity harness (tools/full_scale_parity.py): identities enter in
    staggered waves, walk mostly-linear paths with per-identity speed,
    and a sampled subset carries the lifecycle stressors the small
    fixtures script explicitly — short dropouts, longer-than-buffer
    gaps, birth flicker and periodic confidence dips — so tracker
    behavior at scale covers the same transition graph.
    """
    rng = np.random.default_rng(seed)
    F = n_frames
    objs: list[SynthObject] = []
    for tid in range(1, n_objects + 1):
        # staggered entry/exit: ~60% of identities span most of the clip
        start = 1 if rng.random() < 0.35 else int(rng.integers(1, max(2, F - 60)))
        span_len = int(rng.integers(min(120, F // 2), F))
        end = min(F, start + span_len)
        spans = [(start, end)]
        # short dropout (< default track_buffer 30) for ~25% of tracks
        if rng.random() < 0.25 and end - start > 120:
            cut = int(rng.integers(start + 40, end - 60))
            gap = int(rng.integers(5, 25))
            spans = [(start, cut), (cut + gap, end)]
        # long gap (> buffer: death + re-id pressure) for ~10%
        elif rng.random() < 0.10 and end - start > 260:
            cut = int(rng.integers(start + 60, end - 160))
            gap = int(rng.integers(60, 140))
            spans = [(start, cut), (cut + gap, end)]
        # pedestrian-ish box sizes, clamped for small test canvases
        h = float(rng.uniform(min(70, im_height * 0.2), min(220, im_height * 0.5)))
        w = h * float(rng.uniform(0.32, 0.48))
        speed = rng.uniform(0.5, 3.5)
        theta = rng.uniform(0, 2 * np.pi)
        p0 = (
            float(rng.uniform(0, im_width - w)),
            float(rng.uniform(0, im_height - h)),
        )
        objs.append(
            SynthObject(
                tid,
                spans,
                p0,
                (float(speed * np.cos(theta)), float(speed * np.sin(theta))),
                (w, h),
                conf=float(rng.uniform(0.75, 0.97)),
                conf_dip_every=int(rng.integers(6, 14)) if rng.random() < 0.2 else 0,
                flicker_frames=tuple(
                    range(start + 1, start + 1 + int(rng.integers(2, 5)))
                )
                if rng.random() < 0.15
                else (),
            )
        )
    return SynthScenario(
        n_frames=F,
        im_width=im_width,
        im_height=im_height,
        frame_rate=frame_rate,
        det_noise_px=1.5,
        clutter_per_frame=2.0,
        seed=seed,
        objects=objs,
    )


def render_scenario(sc: SynthScenario) -> tuple[np.ndarray, np.ndarray]:
    """Returns (gt_rows (N,9), det_rows (M,7)) in MOT txt conventions:
    gt:  frame, id, l, t, w, h, consider=1, cls=1, vis=1.0
    det: frame, -1, l, t, w, h, conf
    """
    rng = np.random.default_rng(sc.seed)
    gt, det = [], []
    W, H = sc.im_width, sc.im_height
    for f in range(1, sc.n_frames + 1):
        for obj in sc.objects:
            if not obj.visible(f):
                continue
            jitter = rng.normal(0, 0.3, 2)  # gt wobble
            x, y, w, h = obj.box(f, jitter)
            # clamp to canvas; skip if fully outside
            if x + w < 1 or y + h < 1 or x > W - 1 or y > H - 1:
                continue
            gt.append([f, obj.track_id, x, y, w, h, 1, 1, 1.0])
            if f in obj.flicker_frames:
                continue
            noise = rng.normal(0, sc.det_noise_px, 4)
            conf = obj.conf
            if obj.conf_dip_every and (f % obj.conf_dip_every) == 0:
                conf = 0.3
            conf = float(np.clip(conf + rng.normal(0, 0.02), 0.05, 0.999))
            det.append([
                f, -1,
                x + noise[0], y + noise[1],
                max(8.0, w + noise[2]), max(8.0, h + noise[3]),
                conf,
            ])
        # clutter false positives
        n_cl = rng.poisson(sc.clutter_per_frame)
        for _ in range(n_cl):
            cw, ch = rng.uniform(25, 60), rng.uniform(40, 90)
            cx = rng.uniform(0, W - cw)
            cy = rng.uniform(0, H - ch)
            det.append([f, -1, cx, cy, cw, ch, float(rng.uniform(0.45, 0.75))])
    return np.asarray(gt, np.float64), np.asarray(det, np.float64)


def write_sequence(out_dir: str | Path, name: str = "SYNTH-01",
                   scenario: SynthScenario | None = None) -> Path:
    """Write a MOT-format sequence directory; returns its path."""
    sc = scenario or lifecycle_scenario()
    seq_dir = Path(out_dir) / name
    (seq_dir / "gt").mkdir(parents=True, exist_ok=True)
    (seq_dir / "det").mkdir(parents=True, exist_ok=True)
    gt, det = render_scenario(sc)
    with open(seq_dir / "seqinfo.ini", "w") as fh:
        fh.write(
            "[Sequence]\n"
            f"name={name}\nimDir=img1\nframeRate={sc.frame_rate}\n"
            f"seqLength={sc.n_frames}\nimWidth={sc.im_width}\n"
            f"imHeight={sc.im_height}\nimExt=.jpg\n"
        )
    with open(seq_dir / "gt" / "gt.txt", "w") as fh:
        for r in gt:
            fh.write(
                f"{int(r[0])},{int(r[1])},{r[2]:.2f},{r[3]:.2f},{r[4]:.2f},"
                f"{r[5]:.2f},{int(r[6])},{int(r[7])},{r[8]:.1f}\n"
            )
    with open(seq_dir / "det" / "det.txt", "w") as fh:
        for r in det:
            fh.write(
                f"{int(r[0])},-1,{r[2]:.2f},{r[3]:.2f},{r[4]:.2f},{r[5]:.2f},"
                f"{r[6]:.3f}\n"
            )
    return seq_dir
