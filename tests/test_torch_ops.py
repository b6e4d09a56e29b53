"""Port ops (boxmot_tpu_torch.ops, utils) held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart.  Geometry and IoU are the same operations in the
same order, so they must be bit-equal; the fused IoU + cost twin is held
to the TPU kernel (in interpret mode) and its jnp twin at atol 1e-6.
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
from boxmot_tpu_torch.ops.fused_iou_cost import fused_iou_cost, fused_iou_cost_plain
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


@pytest.mark.parametrize("make", [_boxes, _degenerate], ids=["random", "degenerate"])
@pytest.mark.parametrize("K, D", [(64, 32), (1, 3), (200, 77)])
def test_fused_iou_cost_twin_matches_tpu_kernel(make, K, D):
    rng = np.random.default_rng(K * 1000 + D)
    S = 2
    trk = np.stack([make(rng, K) for _ in range(S)])
    det = np.stack([make(rng, D) for _ in range(S)])
    det[:, :D // 2] = trk[:, :1] + rng.uniform(-30, 30, (S, D // 2, 4)).astype(np.float32)
    conf = rng.uniform(0.05, 1.0, (S, D)).astype(np.float32)
    iou, cost = fused_iou_cost_plain(torch.from_numpy(trk), torch.from_numpy(det),
                                     torch.from_numpy(conf))
    for s in range(S):
        t, d, c = jnp.asarray(trk[s]), jnp.asarray(det[s]), jnp.asarray(conf[s])
        iou_p, cost_p = _fused_iou_cost_pallas(t, d.T, c[None, :], interpret=True)
        iou_j, cost_j = _fused_iou_cost_jnp(t, d, c)
        for ref_iou, ref_cost in ((iou_p, cost_p), (iou_j, cost_j)):
            np.testing.assert_allclose(iou[s].numpy(), np.asarray(ref_iou), rtol=0, atol=1e-6)
            np.testing.assert_allclose(cost[s].numpy(), np.asarray(ref_cost), rtol=0, atol=1e-6)


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
