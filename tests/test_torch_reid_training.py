"""The port's ReID training (``reid/training/*``, ``models/layers.py``,
``models/convert.py::flax_paths``) against the JAX package's, on the CPU.

* Losses and heads: values within 1e-6 (relative); the losses' feature
  gradients within 2e-5 of the largest (circle's gamma of 64 scales its
  logits' rounding).
* Optimizer: ``ProfileOptimizer`` against optax's ``build_tx`` on the same
  gradients (Adam with L2, AdamW, the clip's trigger both ways, the center
  head's SGD) within 1e-6; the schedule at every step within rtol 1e-5 (both
  evaluate it in float32; near the end of the decay one ulp of numpy's and
  XLA's float32 cosine is 2e-6 of 1 + cos); the
  weight-decay mask, LR scales (both ViT profiles) and window scales equal
  to JAX's leaf for leaf for every name of ``MODEL_NAMES`` (JAX's functions
  on the Flax tree that the port's ``flax_paths`` spell out; the forward
  converters land a distinct constant per leaf back on its own key, so
  those paths are the Flax ones).
* Trainer against JAX's: ``tests/test_torch_reid_trainer.py``.
* Resume on the CPU: 4 steps, checkpoint, 4 more equal 8 straight within
  1e-5 (the JAX test's atol); ``n_devices=2`` on one device raises the JAX
  error.
* Data-parallel (``n_devices > 1`` over a mesh of CPU entries,
  ``parallel/training.py``), osnet_x0_25 at P = 4, K = 2: a sharded step
  equals the one-device step in float64 within 1e-10 (losses relative;
  parameters, batch statistics, Adam's moments and EMA absolute) over 2 and
  4 entries; in float32 the first loss within rtol 1e-4 (shards of another
  size may take other convolution algorithms); a batch that does not divide
  raises the JAX trainer's error (reid-mini has 2 identities: P is clipped
  to 2, and the effective batch is 4); a checkpoint written sharded resumes
  unsharded, and one written unsharded resumes sharded, within 1e-5 of the
  uninterrupted sharded run (float64).  The trainer's sharded step against
  JAX's: ``tests/test_torch_reid_trainer.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boxmot_tpu.reid.training import evaluator as jeval
from boxmot_tpu.reid.training import losses as JL
from boxmot_tpu.reid.training import optim as JO
from boxmot_tpu.reid.training import trainer as jtrainer
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.reid import core as tcore
from boxmot_tpu_torch.reid.training import evaluator as teval
from boxmot_tpu_torch.reid.training import losses as TL
from boxmot_tpu_torch.reid.training import optim as TO
from boxmot_tpu_torch.reid.training import trainer as ttrainer

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / "reid-mini"
HW = (64, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


# -- losses and heads -------------------------------------------------------


def _batch(seed=0, n=8, d=16, ids=3):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (n, d)).astype(np.float32)
    labels = np.arange(n) % ids
    return feats, labels


LOSSES = [("ce", lambda f, l, m: m.cross_entropy_label_smooth(f, l, 0.1)),
          ("ce0", lambda f, l, m: m.cross_entropy_label_smooth(f, l, 0.0)),
          ("triplet", lambda f, l, m: m.triplet_loss(f, l, 0.3)),
          ("soft_triplet", lambda f, l, m: m.triplet_loss(f, l, 0.3, soft_margin=True)),
          ("ms", lambda f, l, m: m.multi_similarity_loss(f, l)),
          ("circle", lambda f, l, m: m.circle_loss(f, l))]


@pytest.mark.parametrize("name,fn", LOSSES, ids=[n for n, _ in LOSSES])
def test_losses_equal_jax(name, fn):
    """Values and gradients with respect to the features, on a batch with
    three identities (and, for the triplet, one with a lone anchor)."""
    feats, labels = _batch(len(name))
    if name == "triplet":
        labels[-1] = 7  # an anchor with no positive
    jl = jnp.asarray(labels)
    want, want_g = jax.value_and_grad(lambda f: fn(f, jl, JL))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = fn(f, torch.from_numpy(labels), TL)
    (got_g,) = torch.autograd.grad(got, f)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=2e-5 * max(1.0, np.abs(np.asarray(want_g)).max()))


@pytest.mark.parametrize("head", ["arcface", "cosface", "center"])
def test_heads_equal_jax(head):
    feats, labels = _batch(3)
    jl = jnp.asarray(labels)
    jcls, tcls = {"arcface": (JL.ArcFaceHead, TL.ArcFaceHead),
                  "cosface": (JL.CosFaceHead, TL.CosFaceHead),
                  "center": (JL.CenterHead, TL.CenterHead)}[head]
    jhead = jcls(3, 16) if head == "center" else jcls(3)
    variables = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats), jl))
    want = float(jhead.apply(variables, jnp.asarray(feats), jl))
    thead = tcls(3, 16) if head == "center" else tcls(16, 3)
    thead.load_state_dict(tconvert.state_dict_from_flax_paths(thead, head, variables))
    got = float(thead(torch.from_numpy(feats), torch.from_numpy(labels)).detach())
    assert got == pytest.approx(want, rel=1e-6)


# -- optimizer, schedule and masks -----------------------------------------


@pytest.mark.parametrize("opt,clip,center", [("adam", 0.0, 0.0), ("adamw", 1.0, 0.0),
                                             ("adamw", 1.0, 5e-3), ("adam", 50.0, 5e-3)])
def test_profile_optimizer_equals_optax(opt, clip, center):
    """Five steps on the same gradients: every update within 1e-6 of its
    scale.  The gradients' norm crosses the clip both ways."""
    rng = np.random.default_rng(4)
    params = {"backbone": {"block0": {"attn": {"qkv": {"kernel": rng.normal(size=(4, 6))}}},
                           "norm": {"scale": rng.normal(size=5), "bias": rng.normal(size=5)}},
              "classifier": {"kernel": rng.normal(size=(5, 3)), "bias": rng.normal(size=3)}}
    if center:
        params["center"] = {"centers": rng.normal(size=(3, 5))}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    schedule = jtrainer.make_schedule(jtrainer.TrainConfig(steps=5, warmup_steps=2))
    tx = JO.build_tx(opt, clip, schedule, 5e-4, params, center_loss_weight=center)
    state = tx.init(params)
    flat = {"/".join(str(k.key) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tparams = {p: torch.from_numpy(v.copy()) for p, v in flat.items()}
    topt = TO.ProfileOptimizer(tparams, opt, clip, ttrainer.make_schedule(
        ttrainer.TrainConfig(steps=5, warmup_steps=2)), 5e-4, center)
    jp = params
    for step in range(5):
        g = jax.tree.map(lambda a: np.asarray(rng.normal(size=a.shape) * (3.0 if step % 2 else 0.1),
                                              np.float32), params)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        flat_g = {"/".join(str(k.key) for k in p): v
                  for p, v in jax.tree_util.tree_flatten_with_path(g)[0]}
        tu = topt.update({p: torch.from_numpy(v) for p, v in flat_g.items()}, tparams)
        for p, u in tu.items():
            tparams[p] = tparams[p] + u
        for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
            key = "/".join(str(k.key) for k in p)
            np.testing.assert_allclose(tparams[key].numpy(), np.asarray(v), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} step {step}")


@pytest.mark.parametrize("steps,warmup", [(20, 5), (7, 0), (3, 10), (1000, 100)])
def test_schedule_equals_optax(steps, warmup):
    kw = dict(steps=steps, warmup_steps=warmup, base_lr=3.5e-4)
    want = jtrainer.make_schedule(jtrainer.TrainConfig(**kw))
    got = ttrainer.make_schedule(ttrainer.TrainConfig(**kw))
    for count in range(steps + 6):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-5), count
    assert got(0) == pytest.approx(3.5e-4 / 25 if warmup else 3.5e-4, rel=1e-6)


def _flax_tree(paths: dict, value=None) -> dict:
    """A nested dict (the Flax tree) with a leaf per ("params", *path) of
    ``paths`` (port key -> Flax path): ``value(key)`` or zeros."""
    tree = {}
    for key, (coll, *path) in paths.items():
        node = tree.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value(key) if value else np.zeros((), np.float32)
    return tree


def _classifier(name, center=False, loss="ce"):
    backbone = tcore.build_model(name, HW)
    return ttrainer.ReIDClassifier(backbone, 3, center=center, classifier_loss=loss,
                                   part_dims=tuple(getattr(backbone, "part_dims", ()) or ()))


@pytest.mark.parametrize("name", tcore.MODEL_NAMES)
def test_masks_and_scales_equal_jax(name):
    """JAX's mask functions on the Flax tree of the port's parameters, leaf for
    leaf against the port's; the forward converter lands each leaf's
    distinct constant on its own key (so ``flax_paths`` spells the Flax
    tree)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = _classifier(name, center=name == "vit_tiny_parts", loss="arcface" if name in (
            "resnet50", "clip") else "ce")
    paths = tconvert.flax_paths(model, name)
    ids = {k: i for i, k in enumerate(paths)}
    shapes = {**{k: v.shape for k, v in model.state_dict().items()}}
    backbone_paths = {k.removeprefix("backbone."): ("params" if c == "params" else c, *p[1:])
                      for k, (c, *p) in paths.items() if k.startswith("backbone.")}

    def const(key):
        a = np.full(shapes["backbone." + key], ids["backbone." + key], np.float32)
        coll, *path = backbone_paths[key]
        return np.transpose(a, (2, 3, 1, 0)) if path[-1] == "kernel" and a.ndim == 4 else \
            a.T if path[-1] == "kernel" else a

    tree = _flax_tree(backbone_paths, const)
    if name.startswith("osnet"):
        sd = tconvert.osnet_state_dict_from_flax(tree, name)
    else:
        sd = tconvert.backbone_state_dict_from_flax(tree, name, HW, model=model.backbone)
    for key in backbone_paths:
        assert float(sd[key].flatten()[0]) == ids["backbone." + key], key

    params = _flax_tree({k: v for k, v in paths.items() if v[0] == "params"})["params"]
    ppaths = ["/".join(p[1:]) for p in paths.values() if p[0] == "params"]
    lookup = lambda tree: {"/".join(str(k.key) for k in p): v  # noqa: E731
                           for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert lookup(JO.wd_mask_tree(params)) == TO.wd_mask(ppaths)
    for profile in ("layer_decay", "reid_lrd", "none"):
        want = lookup(JO.lr_scale_tree(params, profile, 0.95))
        got = TO.lr_scales(ppaths, profile, 0.95)
        assert got.keys() == want.keys() and all(got[p] == pytest.approx(want[p], rel=1e-12)
                                                 for p in got), profile
    for got, want in zip(TO.window_scales(ppaths, 2.0), JO.window_scale_trees(params, 2.0)):
        assert got == lookup(want)
    assert TO.resolve_profile("", -1.0, name) == JO.resolve_profile("", -1.0, name)


def test_train_config_equals_jax():
    want = [(f.name, f.default) for f in dataclasses.fields(jtrainer.TrainConfig)]
    assert [(f.name, f.default) for f in dataclasses.fields(ttrainer.TrainConfig)] == want
    assert ttrainer.METRIC_LOSSES == jtrainer.METRIC_LOSSES
    assert ttrainer.CLASSIFIER_LOSSES == jtrainer.CLASSIFIER_LOSSES


# -- resume and configuration ---------------------------------------------


def _kw(name, steps=8):
    return dict(model=name, data_root=str(FIXTURE), crop_hw=HW, p=2, k=2, steps=steps,
                warmup_steps=2, seed=0)


def test_resume_equals_uninterrupted(tmp_path):
    """4 steps, a checkpoint, a new trainer resumed from it, 4 more: the
    parameters, EMA and batch statistics of 8 straight steps within 1e-5."""
    cfg = ttrainer.TrainConfig(**_kw("osnet_x0_25"), ckpt_dir=str(tmp_path))
    straight = ttrainer.ReIDTrainer(cfg, device="cpu")
    straight.fit(log_every=4)
    assert (tmp_path / "ckpt_8.pt").exists()
    first = ttrainer.ReIDTrainer(cfg, device="cpu")
    first.fit(steps=4, log_every=4)
    ck = first.save_checkpoint(tmp_path / "mid.pt")
    resumed = ttrainer.ReIDTrainer(cfg, device="cpu")
    resumed.load_checkpoint(ck)
    resumed.fit(steps=8, log_every=4)
    for (k, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=k)
    for p in straight.ema_params:
        np.testing.assert_allclose(resumed.ema_params[p].numpy(), straight.ema_params[p].numpy(),
                                   rtol=0, atol=1e-5)
    assert [h["loss"] for h in resumed.history] == pytest.approx(
        [h["loss"] for h in straight.history], rel=1e-5)
    # the EMA backbone serves through the facade's model
    backbone = resumed.inference_backbone()
    assert not backbone.training and backbone.feature_dim == 512


def test_float64_trainer_takes_a_float32_checkpoint(tmp_path):
    """``dtype=torch.float64``: a float32 trainer's checkpoint loads into a
    double trainer (model, Adam's moments, EMA), which steps, checkpoints
    and evaluates in double; its step's loss equals the float32 one's
    within float32 rounding."""
    cfg = ttrainer.TrainConfig(**_kw("vit_nano"))
    single = ttrainer.ReIDTrainer(cfg, device="cpu")
    single.fit(steps=2, log_every=1)
    ck = single.save_checkpoint(tmp_path / "f32.pt")
    double = ttrainer.ReIDTrainer(cfg, device="cpu", dtype=torch.float64)
    double.load_checkpoint(ck)
    assert double.opt.count == 2 and double.step == 2
    got = double.fit(steps=3, log_every=1)[-1]["loss"]
    want = single.fit(steps=3, log_every=1)[-1]["loss"]
    assert got == pytest.approx(want, rel=1e-4)
    state = torch.load(double.save_checkpoint(tmp_path / "f64.pt"), weights_only=False)
    assert {t.dtype for t in (*state["opt"]["mu"].values(), *state["ema_params"].values())} == {
        torch.float64}
    assert all(t.dtype == torch.float64 for t in state["model"].values() if t.is_floating_point())
    assert set(double.evaluate()) == {"rank1", "rank5", "mAP"}


def test_n_devices_and_bad_configs_raise():
    with pytest.raises(ValueError, match="n_devices=2 but only 1 present"):
        ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("osnet_x0_25"), n_devices=2),
                             device="cpu")
    with pytest.raises(ValueError, match="unknown metric loss"):
        ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("osnet_x0_25"), loss="nope"),
                             device="cpu")
    with pytest.raises(ValueError, match="unknown ReID model"):
        ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("nope")), device="cpu")
    import inspect

    assert inspect.signature(ttrainer.ReIDTrainer).parameters["device"].default == "cuda"


def _dp_cfg(n_devices=0):
    return ttrainer.TrainConfig(**{**_kw("osnet_x0_25"), "p": 4, "k": 2}, n_devices=n_devices)


def _dp_trainer(n_devices, dtype=torch.float64):
    return ttrainer.ReIDTrainer(_dp_cfg(n_devices), device=("cpu",) * max(n_devices, 1),
                                dtype=dtype)


def _dp_state(tt) -> dict:
    return {**{f"model/{k}": v for k, v in tt.model.state_dict().items() if v.is_floating_point()},
            **{f"mu/{k}": v for k, v in tt.opt.mu.items()},
            **{f"nu/{k}": v for k, v in tt.opt.nu.items()},
            **{f"ema/{k}": v for k, v in tt.ema_params.items()}}


def _assert_states_close(got, want, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def one_device_step():
    """The one-device float64 trainer after one step, and its log."""
    tt = _dp_trainer(0)
    return tt, tt.fit(steps=1, log_every=1)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_step_equals_one_device_float64(one_device_step, n_devices):
    one, want = one_device_step
    tt = _dp_trainer(n_devices)
    assert tt.mesh == (torch.device("cpu"),) * n_devices and tt.device == torch.device("cpu")
    got = tt.fit(steps=1, log_every=1)
    for k in ("loss", "ce", "triplet"):
        assert got[0][k] == pytest.approx(want[0][k], rel=1e-10), k
    _assert_states_close(_dp_state(tt), _dp_state(one), 1e-10)


def test_sharded_step_float32_first_loss():
    want = _dp_trainer(0, torch.float32).fit(steps=1, log_every=1)[0]["loss"]
    got = _dp_trainer(2, torch.float32).fit(steps=1, log_every=1)[0]["loss"]
    assert got == pytest.approx(want, rel=1e-4)


def test_sharded_batch_must_divide_and_checkpoints_cross_meshes(tmp_path):
    with pytest.raises(ValueError, match="effective batch 4 must divide n_devices=3"):
        _dp_trainer(3)
    straight = _dp_trainer(2)
    straight.fit(steps=2, log_every=1)
    ck_sharded = straight.save_checkpoint(tmp_path / "sharded.pt")
    straight.fit(steps=4, log_every=1)
    single = _dp_trainer(0)
    single.fit(steps=2, log_every=1)
    ck_single = single.save_checkpoint(tmp_path / "single.pt")
    for n_devices, ck in ((0, ck_sharded), (2, ck_single)):
        resumed = _dp_trainer(n_devices)
        resumed.load_checkpoint(ck)
        resumed.fit(steps=4, log_every=1)
        _assert_states_close(_dp_state(resumed), _dp_state(straight), 1e-5)
        assert [h["loss"] for h in resumed.history] == pytest.approx(
            [h["loss"] for h in straight.history], rel=1e-5)


def test_ranking_eval_equals_jax():
    rng = np.random.default_rng(7)
    qf, gf = rng.normal(size=(6, 8)).astype(np.float32), rng.normal(size=(15, 8)).astype(np.float32)
    q_pids, g_pids = rng.integers(0, 4, 6), rng.integers(0, 4, 15)
    q_cams, g_cams = rng.integers(0, 2, 6), rng.integers(0, 2, 15)
    for metric in ("cosine", "euclidean"):
        np.testing.assert_array_equal(teval.compute_distance_matrix(qf, gf, metric),
                                      jeval.compute_distance_matrix(qf, gf, metric))
    dist = jeval.compute_distance_matrix(qf, gf)
    got, want = teval.evaluate_rank(dist, q_pids, g_pids, q_cams, g_cams), \
        jeval.evaluate_rank(dist, q_pids, g_pids, q_cams, g_cams)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    args = (dist, jeval.compute_distance_matrix(qf, qf), jeval.compute_distance_matrix(gf, gf))
    np.testing.assert_array_equal(teval.re_ranking(*args, k1=4, k2=2),
                                  jeval.re_ranking(*args, k1=4, k2=2))
