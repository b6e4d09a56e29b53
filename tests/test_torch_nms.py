"""The port's greedy NMS twin (``ops/nms.py::nms_plain``, what K6 computes)
and ``yolox_decode`` against the JAX package's, on the CPU.

Inputs come from numpy seeds (``chip_smoke.nms_edge_sets`` and
``nms_boxes``, which ``chip_smoke.py`` phase 3 also holds K6 to on the
card).  ``keep_idx`` and ``keep_mask`` must be equal exactly: ties go to
the lowest index, IoUs exactly at the threshold do not suppress, NaN IoUs
never suppress, subnormal scores count as zero.  ``scan_model`` is a numpy
model of K6's algorithm (``csrc/nms.cu``: tiers chosen by a radix select,
sorted, scanned in chunks, survivors resolved by an IoU mask walked a word at
a time), held equal to JAX and the twin at small tiers, chunks and words, so
that the algorithm is checked here before the card runs it.  The decoded boxes differ from JAX's by the last bits of
``exp`` (the port rounds the float64 value once): rtol 1e-6; the scores
are sigmoids of the same raw values, one ulp apart at most: atol 2.5e-7.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.ops.nms import batched_class_nms as jax_batched_class_nms
from boxmot_tpu.ops.nms import nms as jax_nms
from boxmot_tpu.ops.nms import yolox_decode as jax_yolox_decode
from boxmot_tpu_torch.ops import nms as tnms
from boxmot_tpu_torch.utils import measure
from chip_smoke import K6_OPS_PER_IOU, k6_bound, k6_work, nms_boxes, nms_edge_sets

# the cluster set at 2,500 boxes: JAX's dense IoU matrix at the card's 23,625
# would take 2.2 GB (the model and the twin take that size below)
EDGE_SETS = nms_edge_sets(np.random.default_rng(7), cluster_n=2500)
FLT_MIN = np.finfo(np.float32).tiny


def _kernel_params() -> dict:
    """K6's parameters, read from ``csrc/nms.cu`` so that the model cannot
    drift from the kernel (a word of the survivor mask is a warp's 32 bits)."""
    src = (Path(tnms.__file__).parent.parent / "csrc" / "nms.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\w+);", src))
    val = lambda name: int(const[const[name]] if const[name] in const else const[name])  # noqa: E731
    return dict(tier_min=val("kTierMin"), tier_max=val("kTierMax"), chunk_min=val("kChunkMin"),
                chunk_max=val("kChunkMax"), sub=val("kSub"), word=32,
                digit_bits=val("kDigitBits"))


# K6's parameters, and small ones that make every set cross tiers, chunks,
# survivor groups and words
KERNEL_PARAMS = _kernel_params()
SMALL_PARAMS = dict(tier_min=8, tier_max=32, chunk_min=4, chunk_max=16, sub=8, word=4,
                    digit_bits=3)


def _pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


def _suppresses(kept, cand, thresh):
    """csrc/nms.cu's ``suppresses``: iou_batch(kept, cand) > thresh in
    float32, NaN-propagating max and min; ``kept`` (K, 4) or (4,) against
    ``cand`` (M, 4) or (4,), broadcast."""
    a, b = np.asarray(kept, np.float32), np.asarray(cand, np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        wh = (np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]),
                         np.float32(0))
              * np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]),
                           np.float32(0)))
        area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
        area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        uni = np.maximum(area_a + area_b - wh, np.float32(1e-12))
        return wh / uni > np.float32(thresh)


def _select_tier(keys, alive, hi, target, digit_bits):
    """``select_tier``: (alive keys below hi, lo) with the tier's keys [lo, hi)
    at least ``target`` (all if fewer) and at most 2 x target."""
    below = keys[alive & (keys < hi)]
    if len(below) <= 2 * target:
        return len(below), 0
    bins = 1 << digit_bits
    rlo, rhi, above = int(below.min()), int(below.max()), 0
    while True:
        top = (rlo ^ rhi).bit_length() - 1
        shift = max(top - (digit_bits - 1), 0)
        base = rlo >> shift
        inside = below[(below >= np.uint64(rlo)) & (below <= np.uint64(rhi))]
        hist = np.bincount(((inside >> np.uint64(shift)) - np.uint64(base)).astype(np.int64),
                           minlength=bins)
        assert len(hist) == bins
        cum = above + np.cumsum(hist[::-1])  # from the largest keys down
        r = int(np.argmax(cum >= target))
        b = bins - 1 - r
        at, cnt = int(cum[r] - hist[b]), int(hist[b])
        blo = max((base + b) << shift, rlo)
        bhi = min(((base + b) << shift) + (1 << shift) - 1, rhi)
        if at + cnt <= 2 * target:
            return len(below), blo
        above, rlo, rhi = at, blo, bhi


def scan_model(boxes, scores, thresh, max_out, tier_min, tier_max, chunk_min, chunk_max, sub,
               word, digit_bits):
    """K6's sorted, chunked, tiered scan in numpy -> (keep_idx (max_out,)
    int32, keep_mask, {"tiers", "chunks", "groups", "examined"})."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    N = len(scores)
    alive = scores >= FLT_MIN
    keys = ((scores.view(np.uint32).astype(np.uint64) << np.uint64(32))
            | (~np.arange(N, dtype=np.uint32)).astype(np.uint64))
    keep = np.full(max_out, -1, np.int32)
    kept = []
    stats = dict(tiers=0, chunks=0, groups=0, examined=0)
    hi = (1 << 64) - 1
    target = min(max(_pow2(2 * min(max_out, tier_max)), tier_min), tier_max)
    while len(kept) < max_out:
        below, lo = _select_tier(keys, alive, np.uint64(hi), target, digit_bits)
        if below == 0:
            break
        tier = keys[alive & (keys >= np.uint64(lo)) & (keys < np.uint64(hi))]
        assert 0 < len(tier) <= 2 * target and (len(tier) >= target or len(tier) == below)
        tier = np.sort(tier)[::-1]
        order = (~tier.astype(np.uint32)).astype(np.int64)  # low word: ~index
        stats["tiers"] += 1
        pos, boost = 0, 0
        while pos < len(order) and len(kept) < max_out:
            c = max(min(max(_pow2(max_out - len(kept)), chunk_min), chunk_max), boost)
            cand = order[pos:pos + c]
            stats["chunks"] += 1
            stats["examined"] += len(cand)
            sup = np.zeros(len(cand), bool)
            if kept:
                sup = _suppresses(boxes[kept][:, None], boxes[cand][None], thresh).any(0)
            surv = cand[~sup]
            n0 = len(kept)
            s0 = 0
            while s0 < len(surv) and len(kept) < max_out:
                w = min(len(surv) - s0, min(sub, max(chunk_min, _pow2(max_out - len(kept)))))
                grp = surv[s0:s0 + w]
                stats["groups"] += 1
                avail = np.ones(w, bool)
                if len(kept) > n0:
                    avail = ~_suppresses(boxes[kept[n0:]][:, None], boxes[grp][None],
                                         thresh).any(0)
                pair = _suppresses(boxes[grp][:, None], boxes[grp][None], thresh)
                mask = pair & np.triu(np.ones((w, w), bool), 1) & avail[:, None] & avail[None]
                words = [np.arange(k, min(k + word, w)) for k in range(0, w, word)]
                intra = np.array([mask[i, words[i // word]].any() for i in range(w)])
                for W, ids in enumerate(words):  # the walk
                    rem = [i for i in ids if avail[i]]
                    took = []
                    while rem:  # a word's kept, in order
                        i = rem.pop(0)
                        took.append(i)
                        if intra[i]:
                            rem = [j for j in rem if not mask[i, j]]
                    took = took[:max_out - len(kept)]
                    for i in took:
                        keep[len(kept)] = grp[i]
                        kept.append(int(grp[i]))
                        avail &= ~mask[i]  # the later words' candidates it suppresses
                    if len(kept) == max_out:
                        break
                s0 += w
            boost = min(2 * c, chunk_max) if len(kept) == n0 else 0
            pos += c
        if below <= 2 * target:
            break
        hi, target = lo, min(2 * target, tier_max)
    return keep, np.arange(max_out) < len(kept), stats


def _jax(boxes, scores, classes, thresh, max_out):
    if classes is None:
        keep, mask = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out)
    else:
        keep, mask = jax_batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(classes), thresh, max_out)
    return np.asarray(keep), np.asarray(mask)


def _port(boxes, scores, classes, thresh, max_out):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    if classes is None:
        keep, mask = tnms.nms(b, s, thresh, max_out)
    else:
        keep, mask = tnms.batched_class_nms(b, s, torch.from_numpy(classes), thresh, max_out)
    return keep.numpy(), mask.numpy()


_JAX_KEEP: dict = {}


def _jax_cached(label, boxes, scores, classes, thresh, max_out):
    """JAX's result on an edge set, once per set (both tests below read it);
    for N = 0 None: JAX's argmax of an empty sequence raises."""
    if label not in _JAX_KEEP:
        if len(scores) == 0:
            with pytest.raises(ValueError, match="empty sequence"):
                _jax(boxes, scores, classes, thresh, max_out)
            _JAX_KEEP[label] = None
        else:
            _JAX_KEEP[label] = _jax(boxes, scores, classes, thresh, max_out)
    return _JAX_KEEP[label]


@pytest.mark.parametrize("case", EDGE_SETS, ids=[c[0] for c in EDGE_SETS])
def test_nms_twin_equals_jax_on_edge_sets(case):
    label, boxes, scores, classes, thresh, max_out = case
    tk, tm = _port(boxes, scores, classes, thresh, max_out)
    assert tk.dtype == np.int32 and tm.dtype == np.bool_ and tk.shape == (max_out,)
    assert (tk[~tm] == -1).all() and (tk[tm] >= 0).all()
    want = _jax_cached(*case)
    if want is None:  # N = 0: the port keeps nothing where JAX raises
        assert not tm.any()
        return
    np.testing.assert_array_equal(tk, want[0])
    np.testing.assert_array_equal(tm, want[1])


@pytest.mark.parametrize("params", [SMALL_PARAMS, KERNEL_PARAMS], ids=["small", "kernel"])
@pytest.mark.parametrize("case", EDGE_SETS, ids=[c[0] for c in EDGE_SETS])
def test_scan_model_equals_jax_and_twin_on_edge_sets(case, params):
    """K6's algorithm (the numpy model) keeps what JAX's loop and the twin
    keep, at small tiers, chunks, groups and words and at the kernel's."""
    label, boxes, scores, classes, thresh, max_out = case
    b = boxes if classes is None else (
        torch.from_numpy(boxes) + torch.from_numpy(classes)[:, None] * tnms.CLASS_OFFSET).numpy()
    mk, mm, _ = scan_model(b, scores, thresh, max_out, **params)
    tk, tm = _port(boxes, scores, classes, thresh, max_out)
    np.testing.assert_array_equal(mk, tk)
    np.testing.assert_array_equal(mm, tm)
    want = _jax_cached(*case)
    if want is not None:
        np.testing.assert_array_equal(mk, want[0])


@pytest.mark.parametrize("max_out, want", [
    (3, (4, 4)),  # A, B, C, D examined (0 + 1 + 1 + 2 IoUs); E not
    (8, (5, 5)),  # every alive one (E: 1 more); F (score -0.0) never
])
def test_k6_work_counts_what_the_sorted_definition_needs(max_out, want):
    """The bound's count: in sorted order A kept, B suppressed by A (one IoU),
    C kept (one: A), D kept (two: A, C), E suppressed by C (one), F not
    alive."""
    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 9], [20, 0, 30, 10], [40, 0, 50, 10],
                          [20, 0, 30, 9.5], [60, 0, 70, 10]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5, -0.0])
    keep, _ = tnms.nms(boxes, scores, 0.5, max_out)
    examined, sorted_iou, _ = k6_work(boxes, scores, keep, 0.5, max_out)
    assert (examined, sorted_iou) == want
    kept = int((keep >= 0).sum())
    assert kept == min(max_out, 3)
    assert k6_bound(6, max_out, examined, sorted_iou) == measure.bound_ms(
        6 * 4 + examined * 16 + max_out * 5, sorted_iou * K6_OPS_PER_IOU)


def test_kernel_params_are_the_kernels():
    assert KERNEL_PARAMS == dict(tier_min=64, tier_max=2048, chunk_min=32, chunk_max=1024,
                                 sub=256, word=32, digit_bits=11)


@pytest.mark.parametrize("label", [
    "every score 1.0 across tiers and chunks", "every score 1.0 across tiers at max_out 64",
    "fewer survivors than max_out past the first tier"])
def test_tier_sets_cross_tiers_at_the_kernels_params(label):
    """The sets named for tiers make the kernel's scan take more than one
    tier (and the max_out 64 one at the fused step's max_out)."""
    _, boxes, scores, classes, thresh, max_out = next(c for c in EDGE_SETS if c[0] == label)
    assert classes is None
    _, _, stats = scan_model(boxes, scores, thresh, max_out, **KERNEL_PARAMS)
    assert stats["tiers"] >= 2, stats


def sort_tier_model(keys, rng):
    """``csrc/nms.cu::sort_tier`` in numpy: the n unique keys padded to P =
    max(32, 2^ceil(log2 n)) with P - 1 - q, runs of 32 sorted by the
    warp's bitonic network, then merge rounds in which each key lands at its
    index in its run plus the keys of the other run above it.  The buffer a
    round writes starts as garbage (``rng``), as shared memory does, so a
    position no key lands on shows."""
    n = len(keys)
    P = max(_pow2(n), 32)
    q = np.arange(P)
    v = np.where(q < n, np.concatenate([keys, np.zeros(P - n, np.uint64)]),
                 (P - 1 - q).astype(np.uint64)).astype(np.uint64)
    k = 2
    while k <= 32:
        j = k >> 1
        while j:
            other = v[q ^ j]
            desc = (k == 32) | ((q & k) == 0)
            keep_max = ((q & j) == 0) == desc
            v = np.where(keep_max, np.maximum(v, other), np.minimum(v, other))
            j >>= 1
        k <<= 1
    L = 32
    while L < P:
        runs = v.reshape(-1, L)
        above = (runs[(q // L) ^ 1] > v[:, None]).sum(1)  # the other run's keys above each
        out = rng.integers(0, 2**63, P, dtype=np.uint64)
        out[(q // L & ~1) * L + q % L + above] = v
        v, L = out, 2 * L
    return v


@pytest.mark.parametrize("n", [1, 31, 33, 531, 1038, 2071, 4096])
def test_sort_tier_model_sorts_with_stale_buffers(n):
    """K6's tier sort puts every key in place whatever its buffers held: the
    padding keys are distinct, so no two keys of a merge tie (equal padding
    once sent two keys to one place and left another holding garbage)."""
    rng = np.random.default_rng(n)
    keys = (rng.choice(2**40, n, replace=False).astype(np.uint64) + np.uint64(2**55))
    got = sort_tier_model(keys, rng)
    np.testing.assert_array_equal(got[:n], np.sort(keys)[::-1])
    assert (got[n:] < np.uint64(2**55)).all()


def test_scan_model_reaches_the_kernel_edges():
    """At the kernel's parameters the new sets reach the edges they name, and
    the model equals the twin on the card's 23,625-box cluster."""
    sets = {c[0]: c for c in nms_edge_sets(np.random.default_rng(7))}
    stats = {}
    for label in ("one cluster of 23625 near-identical boxes",
                  "every score 1.0 across tiers and chunks",
                  "fewer survivors than max_out past the first tier"):
        _, boxes, scores, _, thresh, max_out = sets[label]
        mk, mm, stats[label] = scan_model(boxes, scores, thresh, max_out, **KERNEL_PARAMS)
        tk, tm = _port(boxes, scores, None, thresh, max_out)
        np.testing.assert_array_equal(mk, tk)
        np.testing.assert_array_equal(mm, tm)
        stats[label]["kept"] = int(tm.sum())
    cluster = stats["one cluster of 23625 near-identical boxes"]
    assert cluster["kept"] == 1 and cluster["examined"] == 23625 and cluster["tiers"] > 1
    ones = stats["every score 1.0 across tiers and chunks"]
    assert ones["kept"] == 256 and ones["tiers"] >= 2 and ones["chunks"] >= 3
    few = stats["fewer survivors than max_out past the first tier"]
    assert 0 < few["kept"] < 256 and few["tiers"] >= 2 and few["examined"] == 5000
    _, b, s, _, thresh, max_out = sets["+inf, subnormal, -0.0 and FLT_MIN scores"]
    keep = _port(b, s, None, thresh, max_out)[0]
    keep = keep[keep >= 0]
    assert keep[0] == 0 and np.isinf(s[keep[:3]]).all()  # ties among +inf: lowest index
    assert (s[keep] >= FLT_MIN).all() and (s[keep] == FLT_MIN).any()
    _, b, s, _, thresh, max_out = sets["max_out larger than N"]
    assert 0 < int((_port(b, s, None, thresh, max_out)[0] >= 0).sum()) <= len(s) < max_out


def test_nms_edge_sets_decide_what_they_name():
    """The edge sets reach their edges: the threshold sets keep the box whose
    IoU equals the threshold, the limits bind, NaN boxes are kept."""
    by = {c[0]: c for c in EDGE_SETS}
    keep = {label: _port(*case[1:])[0] for label, case in by.items()}
    n_kept = {label: int((k >= 0).sum()) for label, k in keep.items()}
    assert n_kept["no positive score"] == 0
    assert n_kept["exactly max_out"] == 64 and n_kept["more survivors than max_out"] == 64
    assert 0 < n_kept["fewer survivors than max_out"] < 64
    assert {1, 4} <= set(keep["IoU exactly at the threshold 0.7"].tolist())  # IoU 0.7: kept
    assert 7 not in keep["IoU exactly at the threshold 0.7"].tolist()  # IoU just above: dropped
    assert {2, 5} <= set(keep["IoU exactly at the threshold 0.5"].tolist())
    _, b, s, *_ = by["NaN coordinates"]
    assert np.isnan(b[keep["NaN coordinates"][0]]).any()
    assert n_kept["N = 1"] == 1


def test_nms_twin_equals_jax_at_scale():
    """N = 4000 clustered boxes, max_out 256: the twin tracks JAX at scale."""
    boxes, scores = nms_boxes(np.random.default_rng(11), 4000)
    jk, jm = _jax(boxes, scores, None, 0.7, 256)
    tk, tm = _port(boxes, scores, None, 0.7, 256)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tm, jm)
    assert tm.all()


def test_nms_wrapper_checks_its_arguments():
    b, s = torch.zeros((3, 4)), torch.ones(3)
    with pytest.raises(ValueError, match="boxes must be"):
        tnms.nms(torch.zeros((3, 5)), s, 0.5)
    with pytest.raises(ValueError, match="scores must be"):
        tnms.nms(b, torch.ones(4), 0.5)
    with pytest.raises(TypeError, match="float32"):
        tnms.nms(b.double(), s.double(), 0.5)
    keep, mask = tnms.nms(b, s, 0.5, 0)
    assert keep.shape == (0,) and mask.shape == (0,)


@pytest.mark.parametrize("img_hw", [(64, 96), (256, 320)])
def test_yolox_decode_matches_jax(img_hw):
    n = sum((img_hw[0] // s) * (img_hw[1] // s) for s in (8, 16, 32))
    raw = np.random.default_rng(3).normal(0, 1.5, (n, 7)).astype(np.float32)
    jb, jo, jc = (np.asarray(a) for a in jax_yolox_decode(jnp.asarray(raw), img_hw=img_hw))
    tb, to, tc = (a.numpy() for a in tnms.yolox_decode(torch.from_numpy(raw), img_hw=img_hw))
    assert tb.shape == jb.shape == (n, 4) and tc.shape == jc.shape == (n, 2)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(to, jo, rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2.5e-7)
