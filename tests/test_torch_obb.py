"""The port's oriented-box path against the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions and
their PyTorch counterparts:

* the rotated-IoU twin (``ops.rotated_iou``) against the jnp clip at atol
  1e-6, given the JAX corners (``cos``/``sin`` differ by an ulp between XLA
  and PyTorch, which the clip should not be blamed for), and against the
  Pallas kernel in interpret mode on one 64 x 128 tile at atol 1e-5 (the
  kernel centres each pair elsewhere);
* kernel K3's compact clip, emulated here in float32 scalars, bit-equal to
  the twin: the CUDA kernel runs the same operations on the card;
* ``obb_corners``, ``align_obb_to_ref`` and the XYWH-OBB Kalman layout;
* OBB ByteTrack frame by frame from JAX states carried across, and the live
  tracker on (N, 7) detections: ids, status, masks and ``det_ind`` exact;
* ``run_eval_obb`` on mmot-mini against the JAX package's values.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import boxmot_tpu
from boxmot_tpu.data.mmot import MmotDataset
from boxmot_tpu.motion import kalman as jk
from boxmot_tpu.ops import geometry as jgeo
from boxmot_tpu.ops.pallas_rotated_iou import rotated_iou_pallas
from boxmot_tpu.ops.rotated_iou import iou_batch_obb
from boxmot_tpu.trackers import bytetrack as jbt
from boxmot_tpu_torch import create_tracker, run_eval_obb
from boxmot_tpu_torch.engine.eval import build_replay_config
from boxmot_tpu_torch.engine.eval_obb import mmot_obb_dets, track_sequence_obb
from boxmot_tpu_torch.engine.replay import pack_frames
from boxmot_tpu_torch.motion import kalman as tk
from boxmot_tpu_torch.ops import geometry as tgeo
from boxmot_tpu_torch.ops.rotated_iou import rotated_iou, rotated_iou_plain
from boxmot_tpu_torch.trackers import bytetrack as tbt
from chip_smoke import crossed_quads, synthetic_obb_frames

MMOT = Path(__file__).resolve().parent.parent / "assets" / "mmot-mini" / "train"
# the JAX package's run_eval_obb on mmot-mini, class-averaged, on the CPU
# (boxmot_tpu.engine.eval_obb.run_eval_obb with its defaults)
JAX_OBB_EVAL = {
    "bytetrack": {"HOTA": 0.604123, "MOTA": 0.662654, "IDF1": 0.671799},
    "sfsort": {"HOTA": 0.898815, "MOTA": 0.942670, "IDF1": 0.924151},
}
ATOL = 1e-4
RTOL = 1e-4
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _obbs(rng, n, wmax=300.0, span=(1920, 1080)):
    b = np.zeros((n, 5), F32)
    b[:, 0] = rng.uniform(0, span[0], n)
    b[:, 1] = rng.uniform(0, span[1], n)
    b[:, 2:4] = rng.uniform(2, wmax, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def _degenerate_pair(rng, n, m):
    """Boxes that track near their detections, with the step's edge cases:
    identical, shifted, quarter-turned and half-size boxes, slivers,
    zero-width and point boxes, unit padding boxes at the origin, angles at
    +-pi/2, boxes sharing centre and angle, and far disjoint ones.  Only the
    first argument holds zero-area boxes: a zero-area clip polygon clips
    nothing, so the jnp clip's IoU against it is a1 / (a1 - inter) rounding
    noise, in JAX as in the port, and masked out by every caller."""
    a, b = _obbs(rng, n), _obbs(rng, m)
    k = min(n, m) // 2
    b[:k] = a[:k] + rng.normal(0, 3, (k, 5)).astype(F32)
    b[k:k + 4] = a[k:k + 4]
    b[k + 4:k + 8] = a[k + 4:k + 8]
    b[k + 4:k + 8, 2] *= 0.5
    b[k + 4:k + 8, 4] += np.pi / 2
    b[k + 8] = [0, 0, 1, 1, 0]
    b[k + 9] = [a[0, 0], a[0, 1], 1e-3, 300, 1.0]  # sliver across box 0
    b[k + 10:k + 14, 4] = np.pi / 2 * rng.choice([-1, 1], 4) + rng.normal(0, 1e-6, 4)
    b[k + 14:k + 18, :2] = a[k + 14:k + 18, :2]  # same centre and angle
    b[k + 14:k + 18, 4] = a[k + 14:k + 18, 4]
    b[k + 18] = [1e5, 1e5, 10, 10, 0.3]  # disjoint
    a[k + 8] = 0.0  # an empty slot
    a[k + 9, 2] = 0.0  # zero width
    a[k + 10] = [0, 0, 1, 1, 0]  # padding box
    a[k + 11, 4] = -np.pi / 2
    return a, b


def _jax_corners(x):
    return np.array(jgeo.obb_corners(jnp.asarray(x)))


def _twin(a, b, corners_from_jax=True):
    args = [torch.from_numpy(x)[None] for x in (a, b)]
    if corners_from_jax:
        args += [torch.from_numpy(_jax_corners(x))[None] for x in (a, b)]
    return rotated_iou_plain(*args)[0].numpy()


@pytest.mark.parametrize("kind, n, m", [("random", 64, 80), ("degenerate", 64, 80),
                                        ("ragged", 1, 3), ("ragged", 33, 1), ("ragged", 17, 29)])
def test_twin_equals_jnp_clip(kind, n, m):
    """Against ``iou_batch_obb`` as the JAX package calls it, op by op (a
    jitted call fuses its products and moves some IoUs by ~1.5e-6).  Every
    case draws 64 x 80 boxes, so the op-by-op compiles are shared; a ragged
    case keeps the first n x m (each pair's IoU is independent of the rest)."""
    rng = np.random.default_rng({"random": 0, "degenerate": 1}.get(kind, n * 1000 + m))
    if kind == "degenerate":
        a, b = _degenerate_pair(rng, 64, 80)
    else:  # clustered, so that most pairs overlap
        a, b = _obbs(rng, 64, span=(400, 400)), _obbs(rng, 80, span=(400, 400))
    want = np.asarray(iou_batch_obb(a, b))[:n, :m]
    a, b = a[:n], b[:m]
    got = _twin(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isfinite(got).all()
    if kind != "ragged":
        assert (want > 0.05).sum() > n // 2  # the pairs really overlap
    # with the port's own corners (its own trig) the IoU moves by ulps only
    np.testing.assert_allclose(_twin(a, b, corners_from_jax=False), want, rtol=0, atol=1e-5)


def test_twin_equals_pallas_kernel_on_one_tile():
    rng = np.random.default_rng(7)
    a, b = _obbs(rng, 64, span=(500, 500)), _obbs(rng, 128, span=(500, 500))
    want = np.asarray(rotated_iou_pallas(a, b, interpret=True))
    np.testing.assert_allclose(_twin(a, b), want, rtol=0, atol=1e-5)


def test_twin_self_iou_and_degenerate_values():
    rng = np.random.default_rng(3)
    a = _obbs(rng, 40)
    assert np.diagonal(_twin(a, a)).min() > 0.999
    box = np.array([[0, 0, 10, 10, 0.3]], F32)
    far_and_empty = np.array([[1000, 1000, 10, 10, 1.0], [0, 0, 0, 0, 0.0]], F32)
    np.testing.assert_array_equal(_twin(far_and_empty, box), [[0.0], [0.0]])


K3_FAST = 8  # vertices the kernel's fast path holds (csrc/rotated_iou.cu kFast)


def _k3_emulated(o1, c1, o2, c2):
    """Kernel K3's clip for one pair (csrc/rotated_iou.cu), in float32
    scalars: a compact vertex list, walked in the padded list's order.
    Returns (iou, slow): ``slow`` when a stage emitted more than K3_FAST
    vertices, so that the kernel recomputes the pair on its slow path, which
    runs the same operations over 64-slot lists."""
    ox = (F32(o1[0]) + F32(o2[0])) / F32(2)
    oy = (F32(o1[1]) + F32(o2[1])) / F32(2)
    bx, by = [F32(v) for v in c2[:, 0]], [F32(v) for v in c2[:, 1]]
    wind = F32(0)
    for k in range(4):
        kn = (k + 1) % 4
        wind = wind + (bx[k] * by[kn] - bx[kn] * by[k])
    orient = F32(1) if F32(0.5) * wind >= 0 else F32(-1)
    ex, ey = [v - ox for v in bx], [v - oy for v in by]
    xs, ys = [F32(v) - ox for v in c1[:, 0]], [F32(v) - oy for v in c1[:, 1]]
    rejected = _k3_clipped_away(xs, ys, ex, ey, orient)
    lead, split, slow = False, True, False
    for k in range(4):
        kn = (k + 1) % 4
        dx, dy = ex[kn] - ex[k], ey[kn] - ey[k]
        n = len(xs)
        side = [(dx * (ys[i] - ey[k]) - dy * (xs[i] - ex[k])) * orient for i in range(n)]
        nx, ny = [], []
        s0 = s1 = False
        for q in range(n):
            a = (q + n - 1) % n if lead else q
            b = (a + 1) % n
            in_a, in_b = side[a] >= 0, side[b] >= 0
            if in_a != in_b:
                denom = side[a] - side[b]
                t = side[a] / (F32(1e-30) if abs(denom) < F32(1e-30) else denom)
                nx.append(xs[a] + t * (xs[b] - xs[a]))
                ny.append(ys[a] + t * (ys[b] - ys[a]))
            if in_b:
                nx.append(xs[b])
                ny.append(ys[b])
            if q == 0:
                s0, s1 = split and in_a != in_b, in_b if split else in_a
        # the kernel's shortcuts for a stage whose vertices are all outside
        # (the list empties) or all inside (the list as it is, or rotated left
        # by one unless `lead`; then `lead` holds and `split` stays)
        if not any(s >= 0 for s in side):
            assert not nx
        elif all(s >= 0 for s in side):
            keep = (xs, ys) if lead else (xs[1:] + xs[:1], ys[1:] + ys[:1])
            assert (nx, ny, not s0, s1 if s0 else s1 and split) == (*keep, True, split)
        lead, split = not s0, (s1 if s0 else s1 and split)
        xs, ys = nx, ny
        assert len(xs) <= 4 << (k + 1)  # the slow path's list bound
        slow |= len(xs) > K3_FAST
        if not xs:
            break
    inter = F32(0)
    if xs:
        n = len(xs)
        acc = F32(0)
        for a in ([n - 1] + list(range(n - 1))) if lead else range(n):
            b = (a + 1) % n
            acc = acc + (xs[a] * ys[b] - xs[b] * ys[a])
        inter = F32(0.5) * abs(acc)
    union = F32(o1[2]) * F32(o1[3]) + F32(o2[2]) * F32(o2[3]) - inter
    iou = inter / max(union, F32(1e-12)) if union > 0 else F32(0)
    if rejected:  # the kernel writes 0 without clipping: the clip must agree
        assert not xs and iou == 0
    return iou, slow, rejected


def _k3_clipped_away(xs, ys, ex, ey, orient):
    """The kernel's reject test (csrc/rotated_iou.cu clipped_away): all four
    subject corners outside one clip edge by (|dx| + |dy|) 1e-4 A, with A the
    largest centred coordinate."""
    big = max(abs(v) for v in xs + ys + ex + ey)
    for k in range(4):
        kn = (k + 1) % 4
        dx, dy = ex[kn] - ex[k], ey[kn] - ey[k]
        margin = (abs(dx) + abs(dy)) * big * F32(1e-4)
        if all((dx * (y - ey[k]) - dy * (x - ex[k])) * orient < -margin for x, y in zip(xs, ys)):
            return True
    return False



def test_k3_compact_clip_is_bit_equal_to_twin():
    """The kernel keeps a compact vertex list where the twin keeps 64
    duplicate-padded slots; walked in the padded order, it adds the same
    nonzero shoelace terms in the same order, so the two agree bit for bit
    (the kernel itself is held to the twin on the card)."""
    rng = np.random.default_rng(11)
    a, b = _degenerate_pair(rng, 40, 48)
    b[-1] = 0.0  # a zero-area clip polygon too: the kernel must match the twin there
    A, B = torch.from_numpy(a)[None], torch.from_numpy(b)[None]
    c1, c2 = tgeo.obb_corners(A), tgeo.obb_corners(B)
    twin = rotated_iou_plain(A, B, c1, c2)[0].numpy()
    c1, c2 = c1[0].numpy(), c2[0].numpy()
    got = np.array([[_k3_emulated(a[i], c1[i], b[j], c2[j])[0] for j in range(len(b))]
                    for i in range(len(a))], F32)
    np.testing.assert_array_equal(got.view(np.int32), twin.view(np.int32))
    assert (twin > 0.05).sum() > 40


@pytest.mark.parametrize("kind", ["random", "degenerate", "crossed"])
def test_k3_fast_path_and_overflow_bit_equal_to_twin(kind):
    """The kernel's fast path holds K3_FAST vertices; a pair whose list
    outgrows it takes the slow path.  Either way the bits are the twin's, and
    every pair the reject test skips has the twin's exact 0.  Real boxes are
    convex, so their lists hold at most 8 vertices and never overflow; the
    crossed quadrilaterals do."""
    rng = np.random.default_rng({"random": 21, "degenerate": 22, "crossed": 23}[kind])
    if kind == "crossed":
        (a, c1), (b, c2) = crossed_quads(rng, 40), crossed_quads(rng, 48)
    else:
        a, b = (_degenerate_pair(rng, 40, 48) if kind == "degenerate"
                else (_obbs(rng, 40, span=(300, 300)), _obbs(rng, 48, span=(300, 300))))
        c1, c2 = (tgeo.obb_corners(torch.from_numpy(x)).numpy() for x in (a, b))
    twin = rotated_iou_plain(*(torch.from_numpy(x)[None] for x in (a, b, c1, c2)))[0].numpy()
    got = [[_k3_emulated(a[i], c1[i], b[j], c2[j]) for j in range(len(b))] for i in range(len(a))]
    iou = np.array([[g[0] for g in row] for row in got], F32)
    slow = sum(g[1] for row in got for g in row)
    rejected = sum(g[2] for row in got for g in row)
    np.testing.assert_array_equal(iou.view(np.int32), twin.view(np.int32))
    assert 0 < rejected < (twin == 0).sum()  # the reject test holds back near pairs
    if kind == "crossed":
        assert slow > 0 and (twin > 0).sum() > 100
    else:
        assert slow == 0 and (twin > 0.05).sum() > 20


def test_rotated_iou_wrapper_on_cpu():
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(_obbs(rng, n))[None] for n in (6, 9))
    before = rotated_iou.launches
    np.testing.assert_array_equal(rotated_iou(a, b).numpy(), rotated_iou_plain(a, b).numpy())
    assert rotated_iou.launches == before  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError, match="must be"):
        rotated_iou(a[..., :4].contiguous(), b)
    with pytest.raises(ValueError, match="contiguous"):
        rotated_iou(a, b, c2=tgeo.obb_corners(b).transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        rotated_iou(a.double(), b)


def test_obb_geometry_equals_jax():
    rng = np.random.default_rng(0)
    x = _obbs(rng, 500)
    x[:5, 4] = [np.pi / 2, -np.pi / 2, np.pi, 0.0, -np.pi]
    want = _jax_corners(x)
    got = tgeo.obb_corners(torch.from_numpy(x)).numpy()
    # cos/sin differ by up to an ulp between XLA and PyTorch: ~1e-4 px at 2000 px
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)
    np.testing.assert_allclose(tgeo.obb2xyxy(torch.from_numpy(x)).numpy(),
                               np.asarray(jgeo.obb2xyxy(jnp.asarray(x))), rtol=0, atol=3e-4)
    ang = rng.uniform(-20, 20, 1000).astype(F32)
    np.testing.assert_array_equal(tgeo.wrap_angle(torch.from_numpy(ang)).numpy(),
                                  np.asarray(jgeo.wrap_angle(jnp.asarray(ang))))


def test_align_obb_to_ref_equals_jax():
    rng = np.random.default_rng(1)
    n = 400
    ref = _obbs(rng, n)
    meas = ref + rng.normal(0, 2, (n, 5)).astype(F32)
    turn = rng.integers(0, 4, n)  # the same rectangle, parameterized four ways
    swap = turn >= 2
    meas[swap, 2], meas[swap, 3] = meas[swap, 3].copy(), meas[swap, 2].copy()
    meas[:, 4] += np.array([0, np.pi, np.pi / 2, -np.pi / 2], F32)[turn]
    meas[:10, 2] = 0.0  # clamped at eps
    want = np.asarray(jk.align_obb_to_ref(jnp.asarray(meas), jnp.asarray(ref)))
    got = tk.align_obb_to_ref(torch.from_numpy(meas), torch.from_numpy(ref)).numpy()
    np.testing.assert_array_equal(got[:, :4], want[:, :4])  # the same candidate everywhere
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-6)


def test_obb_kalman_layout_equals_jax():
    rng = np.random.default_rng(2)
    K = 64
    jl = jk.make_xywh_layout(obb=True)
    tl = tk.make_xywh_layout(obb=True)
    assert (tl.name, tl.dx, tl.dz, tl.motion_mat) == (jl.name, jl.dx, jl.dz, jl.motion_mat)
    z = _obbs(rng, K)
    z[:, 4] *= 3.0  # init wraps the angle
    jm, jc = jk.initiate(jl, jnp.asarray(z))
    tm, tc = tk.initiate(tl, torch.from_numpy(z))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    mask = rng.uniform(size=K) < 0.7
    for _ in range(3):
        jm, jc = jk.predict(jl, jm, jc, jnp.asarray(mask))
        tm, tc = tk.predict(tl, tm, tc, torch.from_numpy(mask))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
        meas = np.asarray(jm)[:, :5] + rng.normal(0, 2, (K, 5)).astype(F32)
        jm, jc = jk.update(jl, jm, jc, jnp.asarray(meas), jnp.zeros(K), jnp.asarray(mask))
        tm, tc = tk.update(tl, tm, tc, torch.from_numpy(meas), torch.from_numpy(mask))
        scale = np.abs(np.asarray(jc)).max()
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=1e-3)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=RTOL * scale)


def _jax_states_to_numpy(states):
    return {f.name: np.stack([np.asarray(getattr(s, f.name)) for s in states])
            for f in dataclasses.fields(jbt.ByteTrackState)}


# the live trackers' resolution of the YAML defaults, at capacity 64, so the
# step test and the live test share one JAX compile
LIVE_OBB_CFG = dict(track_thresh=0.6, match_thresh=0.9, det_thresh=0.6, max_time_lost=30,
                    capacity=64, is_obb=True)


@pytest.mark.parametrize("carry_at", [0, 9])
def test_obb_bytetrack_step_frame_by_frame_equals_jax(carry_at):
    n_frames, D = 24, 64
    seqs = [synthetic_obb_frames(n_frames, 45, seed=1), synthetic_obb_frames(n_frames, 30, seed=2)]
    packed = np.stack([pack_frames(s, D=D, F=n_frames, det_cols=7)[0] for s in seqs])
    jcfg, tcfg = jbt.ByteTrackConfig(**LIVE_OBB_CFG), tbt.ByteTrackConfig(**LIVE_OBB_CFG)
    jstates = [jbt.init_state(jcfg) for _ in seqs]
    tstate, rows = None, 0
    for f in range(n_frames):
        if f == carry_at:
            tstate = tbt.state_from_numpy(_jax_states_to_numpy(jstates), "cpu")
        outs, masks = [], []
        for s in range(len(seqs)):
            dets = jnp.asarray(packed[s, f])
            jstates[s], out, mask = jbt.bytetrack_step(jcfg, jstates[s], dets, dets[:, 5] >= 0)
            outs.append(np.asarray(out))
            masks.append(np.asarray(mask))
        if tstate is None:
            continue
        dets = torch.from_numpy(packed[:, f])
        tstate, tout, tmask = tbt.bytetrack_step(tcfg, tstate, dets, dets[..., 5] >= 0)
        got, want = tbt.state_to_numpy(tstate), _jax_states_to_numpy(jstates)
        for name in ("status", "activated", "tid", "det_ind", "cls", "frame_id", "start_frame",
                     "tracklet_len", "frame_count", "next_id"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{name} at frame {f}")
        live = want["status"] > 0
        np.testing.assert_allclose(got["mean"][live], want["mean"][live], rtol=RTOL, atol=1e-3)
        np.testing.assert_array_equal(tmask.numpy(), np.stack(masks), err_msg=f"mask at {f}")
        tout, jout = tout.numpy(), np.stack(outs)
        assert tout.shape[-1] == 9
        np.testing.assert_array_equal(tout[..., 5:], jout[..., 5:], err_msg=f"out at {f}")
        np.testing.assert_allclose(tout[..., :5], jout[..., :5], rtol=RTOL, atol=1e-3)
        rows += int(tmask.sum())
    assert rows > 400  # the sequences really track
    assert int(tstate.lap_capped.sum()) == 0


def test_obb_state_round_trip_and_init():
    jcfg = jbt.ByteTrackConfig(capacity=16, is_obb=True)
    st = jbt.init_state(jcfg)
    want = _jax_states_to_numpy([st, st])
    got = tbt.state_to_numpy(tbt.init_state(tbt.ByteTrackConfig(capacity=16, is_obb=True), 2, "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    back = tbt.state_to_numpy(tbt.state_from_numpy(want, "cpu"))
    assert all(np.array_equal(back[k], want[k]) for k in want)


@pytest.mark.parametrize("name", ["bytetrack", "sfsort"])
def test_live_obb_update_equals_jax(name):
    img = np.zeros((1080, 1920, 3), np.uint8)
    rows = 0
    # 33-60 boxes a frame: one detection bucket, so one JAX compile
    for seed in (4, 5):
        frames = synthetic_obb_frames(12, 50, seed=seed)
        jt = boxmot_tpu.create_tracker(name, capacity=64)
        tt = create_tracker(name, device="cpu", capacity=64)
        for f, dets in enumerate(frames):
            want = np.asarray(jt.update(dets, img))
            got = np.asarray(tt.update(dets, img))
            assert got.shape == want.shape and got.shape[1] == 9, f
            np.testing.assert_array_equal(got[:, 5:], want[:, 5:], err_msg=f"frame {f}")
            np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=RTOL, atol=1e-3)
            rows += len(got)
        assert tt.is_obb and tt.cfg.is_obb
        assert tt.update(None, img).shape == (0, 9)
    assert rows > 300


def test_run_eval_obb_bytetrack_reproduces_jax(tmp_path):
    res = run_eval_obb(MMOT, "bytetrack", device="cpu", output_dir=tmp_path)
    for k, v in JAX_OBB_EVAL["bytetrack"].items():
        assert abs(float(res["combined"][k]) - v) <= ATOL, (k, res["combined"])
    assert sorted(p.stem for p in tmp_path.iterdir()) == sorted(MmotDataset(MMOT).names)
    rows = np.loadtxt(tmp_path / "data23-1.txt", delimiter=",", ndmin=2)
    assert rows.shape[1] == 13 and len(rows) > 50
    # one sequence alone gives the rows the batched eval wrote for it
    cfg = build_replay_config("bytetrack", is_obb=True)
    alone = track_sequence_obb(cfg, mmot_obb_dets(MMOT)["data23-1"], device="cpu")
    np.testing.assert_allclose(alone, rows, rtol=1e-6, atol=1e-4)  # written with %.10g
