"""Port ops (boxmot_tpu_torch.ops, utils) held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  Geometry and IoU are the same operations in the
same order, so they must be bit-equal; the fused IoU + cost twin is held,
in both of its modes, to the TPU kernel (in interpret mode) and its jnp
twin at atol 1e-6.  K1's launch geometry, which the kernel cannot show
here, is held to cover every pair once.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.ops import geometry as jgeo
from boxmot_tpu.ops.iou import iou_batch as j_iou_batch
from boxmot_tpu.ops.pallas_kernels import _fused_iou_cost_jnp, _fused_iou_cost_pallas
from boxmot_tpu_torch.csrc import build
from boxmot_tpu_torch.ops import geometry as tgeo
from boxmot_tpu_torch.ops.fused_iou_cost import (
    THREADS,
    fused_iou_cost,
    fused_iou_cost_plain,
    launch_geometry,
)
from boxmot_tpu_torch.ops.iou import iou_batch
from boxmot_tpu_torch.utils.device import resolve_device


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _boxes(rng, n):
    b = np.zeros((n, 4), np.float32)
    b[:, :2] = rng.uniform(0, 1800, (n, 2))
    b[:, 2:] = b[:, :2] + rng.uniform(5, 200, (n, 2))
    return b


def _degenerate(rng, n):
    """Detector boxes mixed with the boxes the step really produces at its
    edges: zero-area empty slots, unit padding boxes, touching and nested
    boxes, and tiny boxes."""
    b = _boxes(rng, n)
    b[0::7] = 0.0  # empty slot: xyah2xyxy of a zero mean
    b[1::7] = [0.0, 0.0, 1.0, 1.0]  # padding detection
    b[2::7, 2] = b[2::7, 0]  # zero width
    dup = b[4::7]
    b[3::7][: len(dup)] = dup  # exact duplicates
    b[5::7, 2:] = b[5::7, :2] + 1e-3  # tiny
    return b


def test_geometry_bit_equal():
    rng = np.random.default_rng(0)
    xyxy = _boxes(rng, 300)
    xyah = np.array(jgeo.xyxy2xyah(jnp.asarray(xyxy)))
    np.testing.assert_array_equal(tgeo.xyxy2xyah(torch.from_numpy(xyxy)).numpy(), xyah)
    np.testing.assert_array_equal(
        tgeo.xyah2xyxy(torch.from_numpy(xyah)).numpy(), np.asarray(jgeo.xyah2xyxy(jnp.asarray(xyah)))
    )
    ang = rng.uniform(-20, 20, 500).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.wrap_angle(torch.from_numpy(ang)).numpy(), np.asarray(jgeo.wrap_angle(jnp.asarray(ang)))
    )


@pytest.mark.parametrize("make", [_boxes, _degenerate], ids=["random", "degenerate"])
def test_iou_batch_bit_equal(make):
    rng = np.random.default_rng(1)
    a, b = make(rng, 70), make(rng, 45)
    b[:10] = a[:10] + rng.uniform(-20, 20, (10, 4)).astype(np.float32)  # overlaps
    got = iou_batch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_iou_batch(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("iou_only", [False, True], ids=["iou+cost", "iou-only"])
@pytest.mark.parametrize("make", [_boxes, _degenerate], ids=["random", "degenerate"])
@pytest.mark.parametrize("K, D", [(64, 32), (1, 3), (200, 77)])
def test_fused_iou_cost_twin_matches_tpu_kernel(make, K, D, iou_only):
    rng = np.random.default_rng(K * 1000 + D)
    S = 2
    trk = np.stack([make(rng, K) for _ in range(S)])
    det = np.stack([make(rng, D) for _ in range(S)])
    det[:, :D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4)).astype(np.float32)
    conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
    iou, cost = fused_iou_cost_plain(torch.from_numpy(trk), torch.from_numpy(det),
                                     None if iou_only else torch.from_numpy(conf))
    assert (cost is None) == iou_only
    for s in range(S):
        t, d, c = jnp.asarray(trk[s]), jnp.asarray(det[s]), jnp.asarray(conf[s])
        iou_p, cost_p = _fused_iou_cost_pallas(t, d.T, c[None, :], interpret=True)
        iou_j, cost_j = _fused_iou_cost_jnp(t, d, c)
        for ref_iou, ref_cost in ((iou_p, cost_p), (iou_j, cost_j)):
            np.testing.assert_allclose(iou[s].numpy(), np.asarray(ref_iou), rtol=0, atol=1e-6)
            if not iou_only:
                np.testing.assert_allclose(cost[s].numpy(), np.asarray(ref_cost), rtol=0,
                                           atol=1e-6)


def test_fused_iou_equals_step_iou_on_degenerate_boxes():
    """The 1e-9 union clamp (TPU kernel) and the 1e-12 clamp (iou_batch, the
    JAX step) give the same IoU on the boxes the step sees."""
    rng = np.random.default_rng(2)
    trk = torch.from_numpy(_degenerate(rng, 64))[None]
    det = torch.from_numpy(_degenerate(rng, 48))[None]
    iou, _ = fused_iou_cost_plain(trk, det, torch.ones(1, 48))
    np.testing.assert_array_equal(iou.numpy(), iou_batch(trk, det).numpy())


def test_fused_iou_cost_wrapper_dispatch_and_checks():
    rng = np.random.default_rng(3)
    trk = torch.from_numpy(np.stack([_boxes(rng, 8)]))
    det = torch.from_numpy(np.stack([_boxes(rng, 5)]))
    conf = torch.rand(1, 5)
    before = fused_iou_cost.launches
    iou, cost = fused_iou_cost(trk, det, conf)
    ref_iou, ref_cost = fused_iou_cost_plain(trk, det, conf)
    assert torch.equal(iou, ref_iou) and torch.equal(cost, ref_cost)
    assert fused_iou_cost.launches == before  # a CPU tensor never reaches the kernel
    with pytest.raises(TypeError):
        fused_iou_cost(trk.double(), det, conf)
    with pytest.raises(ValueError):
        fused_iou_cost(trk, det, conf[:, :3])
    with pytest.raises(ValueError):
        fused_iou_cost(trk, det.transpose(1, 2).contiguous(), conf)
    with pytest.raises(ValueError):
        fused_iou_cost(trk, det[:, ::2], conf[:, ::2])


def test_fused_iou_cost_iou_only_on_cpu():
    """Without conf the wrapper returns (iou, None), the twin's IoU, and
    launches nothing on a CPU tensor; its checks still raise."""
    rng = np.random.default_rng(4)
    trk = torch.from_numpy(np.stack([_degenerate(rng, 9)]))
    det = torch.from_numpy(np.stack([_degenerate(rng, 6)]))
    before = fused_iou_cost.launches
    iou, cost = fused_iou_cost(trk, det)
    assert cost is None and fused_iou_cost.launches == before
    assert torch.equal(iou, fused_iou_cost_plain(trk, det, torch.rand(1, 6))[0])
    with pytest.raises(TypeError):
        fused_iou_cost(trk, det.double())
    with pytest.raises(ValueError):
        fused_iou_cost(trk, det[:, ::2])


def _k1_coverage(S, K, D, g):
    """How often K1 at launch g writes each (s, k, d): the kernel's index
    walk (csrc/iou_cost.cu) over its grid (row_blocks, S) and blocks (quads,
    lanes), counted per row and per detection (the walk is their product)."""
    per_row = np.zeros(K, np.int64)
    for bx in range(g.row_blocks):
        k0 = bx * g.rows
        for ty in range(g.lanes):
            np.add.at(per_row, np.arange(k0 + ty, k0 + min(g.rows, K - k0), g.lanes), 1)
    per_det = np.zeros(D, np.int64)
    quads = -(-D // 4)
    for tx in range(g.quads):
        for c in range(tx, quads, g.quads):
            per_det[4 * c:min(4 * c + 4, D)] += 1
    return S * g.row_blocks, np.multiply.outer(per_row, per_det)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("K", [1, 200, 256])
@pytest.mark.parametrize("S", [1, 8])
def test_k1_launch_geometry_covers_every_pair_once(S, K, sms):
    for D in (1, 3, 77, 128, 256, 512):
        g = launch_geometry(S, K, D, sms)
        blocks, count = _k1_coverage(S, K, D, g)
        assert count.shape == (K, D) and (count == 1).all(), (S, K, D, sms, g)
        assert g.rows * (g.row_blocks - 1) < K <= g.rows * g.row_blocks  # no empty block
        assert blocks <= sms  # about one wave
        assert 1 <= g.quads * g.lanes <= THREADS
        assert g.vec == (D % 4 == 0)


def test_resolve_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_resolve_device_sets_precision_guard():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_failed_kernel_build_raises_with_nvcc_output(tmp_path, monkeypatch):
    """A build that fails raises with the compiler's output; nothing falls back."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'iou_cost.cu(1): error: deliberately broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="deliberately broken"):
        build.build("iou_cost")
    assert not list((tmp_path / "out").iterdir())  # no partial library is left


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    a = build.library_path("iou_cost")
    assert a.parent == build.BUILD_DIR and a.name.startswith("iou_cost-")
    assert build.library_path("auction") != a
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("iou_cost") != a


@pytest.mark.parametrize("counts, keep", [
    ([403], None),  # one trace: take another
    ([403, 403], 1),  # two agree
    ([401, 403], None),  # the first lost events: take a third
    ([401, 403, 403], 2),
    ([403, 401, 403], 2),
    ([399, 401, 400], 1),  # no two agree after three: the most kernels
    ([0, 0], None),  # empty traces agree with none
    ([0, 0, 0], None),
    ([0, 0, 403], 2),
    ([403, 0, 0], 0),
    ([0] * 6, 5),  # six empty traces: the function launches nothing
])
def test_profile_keeps_a_trace_that_another_confirms(counts, keep):
    from boxmot_tpu_torch.utils.measure import settled_trace
    assert settled_trace(counts) == keep


@pytest.mark.parametrize("prefix, tables, want", [
    # one launch a call (K1-K6's wrappers): the time a launch; a whole kernel
    # name is a prefix of itself
    ("iou_cost_kernel",
     [{"void iou_cost_kernel<true>(float4 const*)": (4, 12.0), "empty_kernel()": (4, 1.0)}],
     3.0e-3),
    # two kernels a call, each timed: a call's sum; other names left out
    ("nms_", [{"void (anonymous namespace)::nms_select(int)": (4, 8.0),
               "nms_scan(int)": (4, 20.0), "elementwise_kernel": (4, 9.0)}], 7.0e-3),
    # a trace that lost a few launches: the mean over the calls it holds
    ("auction_", [{"auction_kernel<true>()": (3, 6.6)}], 2.2e-3),
    ("nms_", [{"nms_select(int)": (4, 8.0), "nms_scan(int)": (3, 15.0)}], 23.0 / 3.5 * 1e-3),
    # a trace that lost most launches is taken again, through a run of losses
    ("oru_", [{"oru_kernel<0>()": (1, 1.0)}, {}, {}, {"oru_kernel<0>()": (3, 6.0)}], 2.0e-3),
])
def test_device_ms_per_call_sums_a_calls_prefixed_kernels(monkeypatch, prefix, tables, want):
    from boxmot_tpu_torch.utils import measure
    seen = iter(tables)
    monkeypatch.setattr(measure, "_traced", lambda fn, calls: next(seen))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(measure, "RETAKE_PAUSE_S", 0.0)
    got = measure.device_ms_per_call(lambda: None, prefix, reps=4, warmup=0)
    assert got == pytest.approx(want)
    assert next(seen, None) is None  # no trace taken past the one kept


def test_device_ms_per_call_raises_when_every_trace_loses_the_kernel(monkeypatch):
    from boxmot_tpu_torch.utils import measure
    monkeypatch.setattr(measure, "_traced", lambda fn, calls: {"nms_scan()": (3, 1.0)})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(measure, "RETAKE_PAUSE_S", 0.0)
    with pytest.raises(RuntimeError, match="3 launches of 'nms_'"):
        measure.device_ms_per_call(lambda: None, "nms_", reps=8, warmup=0)
    monkeypatch.setattr(measure, "_traced", lambda fn, calls: {})
    with pytest.raises(RuntimeError, match="0 launches of 'nms_'"):
        measure.device_ms_per_call(lambda: None, "nms_", reps=8, warmup=0)


def test_kernel_name_strips_type_namespace_template_and_parameters():
    from boxmot_tpu_torch.utils.measure import kernel_name
    assert kernel_name("void (anonymous namespace)::crops_kernel<true, float>(unsigned char "
                       "const*, float*)") == "crops_kernel"
    assert kernel_name("nms_sorted_scan(float4 const*, float const*, int)") == "nms_sorted_scan"
