"""The port's sequence-parallel replay (``boxmot_tpu_torch/parallel/
replay.py``) against the JAX package's, on the CPU.

JAX shards its replay over the suite's eight virtual CPU devices; the
port's mesh here is eight ``torch.device("cpu")`` entries (on one H100 the
mesh is the one card).  Five sequences pad to eight, as in JAX.
Tolerances: ByteTrack's ``S_pad`` rows (ids, masks, classes and
``det_ind`` exact, boxes and confidences within 1e-4) equal JAX's; a mesh
of one entry is ``batch_replay``, to the bit; BoT-SORT with embeddings and
warps over the padded mesh equals ``batch_replay`` of the five sequences
(ids, masks and ``det_ind`` exact, boxes 1e-4), its padded sequences
empty; ``sharded_reid_features`` of five NHWC crops within 1e-4 of JAX's
with the same carried weights, and within 1e-6 of ``ReID._embed``, also
through replicas.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch

from boxmot_tpu.parallel import replay as jpar
from boxmot_tpu.trackers.bytetrack import ByteTrackConfig as JaxByteTrackConfig
from boxmot_tpu_torch.engine.replay import batch_replay, init_states
from boxmot_tpu_torch.parallel import replay as tpar
from boxmot_tpu_torch.reid import ReID
from boxmot_tpu_torch.trackers.botsort import BotSortConfig
from boxmot_tpu_torch.trackers.bytetrack import ByteTrackConfig
from tests.test_torch_export import HW, carried

ATOL = 1e-4
CPU_MESH = (torch.device("cpu"),) * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def synthetic_batch(S, F, D, seed=0):
    """``tests/test_parallel.py``'s batch: three boxes a sequence on straight
    paths, the rest padding."""
    rng = np.random.default_rng(seed)
    dets = np.zeros((S, F, D, 7), np.float32)
    dets[..., 2:4] = 1.0
    dets[..., 4] = -1.0
    for s in range(S):
        base = rng.uniform(50, 400, (3, 2))
        vel = rng.uniform(-3, 3, (3, 2))
        for f in range(F):
            for i in range(3):
                x, y = base[i] + vel[i] * f
                dets[s, f, i] = [x, y, x + 50, y + 90, 0.9, 0, i]
    return dets


def assert_outputs_equal(got, want, masks_got, masks_want):
    """Masks exact; where a slot is live, ids, classes and det_ind exact and
    boxes and confidences within 1e-4."""
    np.testing.assert_array_equal(masks_got, masks_want)
    g, w = got[masks_got], want[masks_want]
    np.testing.assert_array_equal(g[:, [4, 6, 7]], w[:, [4, 6, 7]])
    np.testing.assert_allclose(g[:, [0, 1, 2, 3, 5]], w[:, [0, 1, 2, 3, 5]], rtol=0, atol=ATOL)


def test_sharded_batch_replay_equals_jax():
    assert len(jax.devices()) >= 8
    dets = synthetic_batch(5, 16, 8)
    _, jouts, jmasks = jpar.sharded_batch_replay(JaxByteTrackConfig(capacity=32), dets,
                                                 jpar.sequence_mesh())
    jouts, jmasks = np.asarray(jouts), np.asarray(jmasks)
    states, outs, masks = tpar.sharded_batch_replay(ByteTrackConfig(capacity=32), dets, CPU_MESH)
    assert outs.shape == jouts.shape == (8, 16, 32, 8) and masks.shape == (8, 16, 32)
    assert states.mean.shape[0] == 8 and outs.device == CPU_MESH[0]
    assert_outputs_equal(outs.numpy(), jouts, masks.numpy(), jmasks)
    assert masks[:5].any() and not masks[5:].any()


def test_mesh_of_one_is_batch_replay():
    cfg = ByteTrackConfig(capacity=32)
    dets = synthetic_batch(5, 16, 8, seed=1)
    _, outs, masks = tpar.sharded_batch_replay(cfg, dets, tpar.sequence_mesh(["cpu"]))
    _, want, want_masks = batch_replay(cfg, init_states(cfg, 5, torch.device("cpu")),
                                       torch.from_numpy(dets))
    assert torch.equal(outs, want) and torch.equal(masks, want_masks)


def test_padded_embeddings_and_warps():
    """BoT-SORT over the eight-entry mesh: the five real sequences as one
    ``batch_replay`` of them, the three padded ones (zero embeddings,
    identity warps, no detections) without a track."""
    cfg = BotSortConfig(capacity=32, feat_dim=16)
    S, F, D = 5, 12, 8
    rng = np.random.default_rng(2)
    dets = synthetic_batch(S, F, D, seed=2)
    embs = rng.normal(size=(S, F, D, 16)).astype(np.float32)
    warps = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (S, F, 2, 3)).copy()
    warps[..., 0, 2] = rng.uniform(-2, 2, (S, F))
    _, outs, masks = tpar.sharded_batch_replay(cfg, dets, CPU_MESH, embs, warps)
    _, want, want_masks = batch_replay(cfg, init_states(cfg, S, torch.device("cpu")),
                                       torch.from_numpy(dets), embs=torch.from_numpy(embs),
                                       warps=torch.from_numpy(warps))
    assert outs.shape[0] == masks.shape[0] == 8 and not masks[S:].any()
    assert_outputs_equal(outs[:S].numpy(), want.numpy(), masks[:S].numpy(), want_masks.numpy())


def test_sharded_reid_features_equals_jax(monkeypatch):
    jmodel, variables, model = carried("osnet_x0_25", seed=6)
    reid = ReID(model_name="osnet_x0_25", device="cpu", crop_hw=HW)
    reid.model.load_state_dict(model.state_dict())
    jreid = types.SimpleNamespace(model=jmodel, variables=variables, feature_dim=512)
    crops = np.random.default_rng(0).uniform(-2, 2, (5, *HW, 3)).astype(np.float32)
    got = tpar.sharded_reid_features(reid, crops, CPU_MESH)
    want = jpar.sharded_reid_features(jreid, crops, jpar.sequence_mesh())
    assert got.shape == want.shape == (5, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    with torch.no_grad():
        local = reid._embed(torch.from_numpy(crops).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got, local.numpy(), rtol=0, atol=1e-6)
    assert tpar.sharded_reid_features(reid, crops[:0], CPU_MESH).shape == (0, 512)
    # the entries of a mesh of several cards run replicas of the model
    monkeypatch.setattr(tpar, "_same_device", lambda a, b: False)
    replicated = tpar.sharded_reid_features(reid, crops, CPU_MESH[:2])
    np.testing.assert_allclose(replicated, local.numpy(), rtol=0, atol=1e-6)
    assert len(reid._replicas) == 1 and reid._replicas[torch.device("cpu")] is not reid.model


def test_mesh_and_shards():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tpar.sequence_mesh()
    mesh = tpar.sequence_mesh(["cpu", "cpu"])
    assert mesh == (torch.device("cpu"), torch.device("cpu"))
    tree = {"a": np.arange(8.0).reshape(4, 2), "b": [torch.arange(4)], "c": None}
    shards = tpar.shard_over_sequences(mesh, tree)
    assert [s["a"].tolist() for s in shards] == [[[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0], [6.0, 7.0]]]
    assert [s["b"][0].tolist() for s in shards] == [[0, 1], [2, 3]] and shards[1]["c"] is None
    with pytest.raises(ValueError, match="not a multiple"):
        tpar.shard_over_sequences(tpar.sequence_mesh(["cpu"] * 3), tree)
