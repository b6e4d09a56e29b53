"""The port's ``ReIDTrainer`` (``reid/training/trainer.py``) against the JAX
package's, on the CPU.

The JAX ``ReIDTrainer`` and the port's on ``assets/reid-mini`` at 64 x 32,
P = K = 2, from the same seeded Flax variables (JAX's ``init`` replaced by
``jax.eval_shape`` and seeded numpy, as the other tests make weights).

* vit_nano (AdamW, clip 1.0, layer decay) runs 4 steps uninterrupted in
  both: losses within rtol 1e-4, batch statistics within 1e-4, parameters
  and EMA within 1e-4; ``evaluate()`` of the EMA weights gives the same
  rank-1, rank-5 and mAP (1e-6).
* osnet_x0_25 (Adam with L2) runs 4 steps uninterrupted in float64 in
  both (``jax.enable_x64``; the port's ``dtype=torch.float64``): losses
  within rtol 1e-10, parameters, batch statistics, Adam's moments and
  EMA within 1e-8 (read: losses 2e-13 apart, parameters 4.5e-10).
* The same in float64 with ``n_devices=2``, one step: the port's trainer
  over the mesh ("cpu", "cpu") (``parallel/training.py``) against the JAX
  trainer over two of the suite's virtual devices, within the same bounds.
* The same run in float32, with 4 crops a batch normalized by batch
  norms over 4 x 2 maps, is chaotic: the first losses already differ by
  3e-5 relative (each package's 1e-6 to 4e-5 from the float64 value, on
  different terms: JAX's cross-entropy, the port's triplet), and by 1 %
  at step 4.  The float32 test therefore starts each of its steps from
  the JAX trainer's state (parameters, batch statistics, Adam's moments
  and count, EMA): losses within rtol 1e-4, batch statistics within 1e-4,
  and parameters within 1e-4 but for at most 0.1 % of the elements
  (observed: 17 of 220,000, where Adam's ratio of moments cancels).
* In float32, parameters whose gradient is 0 in exact arithmetic (a
  per-channel affine ahead of a batch norm in train mode: OSNet's
  ``fc.0.bias``, the ViT's final ``norm``) move by Adam's normalization of
  rounding noise in both packages: they are held to Adam's bound, 2 x LR x
  scale a step.  Those tensors are found by their JAX gradient: RMS below
  1e-6 of the model's largest gradient element.  Every element, of every
  tensor, is held to that bound.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from boxmot_tpu.reid.training import trainer as jtrainer
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.reid.training import trainer as ttrainer

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / "reid-mini"
HW = (64, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _fill(path, leaf, rng):
    key, shape = path[-1].key, leaf.shape
    if key == "kernel":
        return rng.normal(0, math.sqrt(1.0 / np.prod(shape[:-1])), shape)
    if key in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    if key in ("cls_token", "pos_embed"):
        return rng.normal(0, 0.02, shape)
    return rng.normal(0, 0.1, shape)


_SHAPES: dict = {}  # the Flax variables' shapes by model and input shapes, traced once


def jax_trainer(cfg, seed=1, dtype=np.float32):
    """The JAX trainer with seeded Flax variables: its eager ``init`` (about
    20 s for OSNet) replaced by ``jax.eval_shape`` (once a model and input
    shape for this module) and seeded numpy, values that float32 holds
    exactly, as ``dtype``."""
    rng = np.random.default_rng(seed)

    def init(self, key, *args, **kw):
        tag = (cfg.model, self.num_classes, cfg.classifier_loss, cfg.center_loss_weight > 0,
               tuple(np.shape(a) for a in args))
        if tag not in _SHAPES:
            _SHAPES[tag] = jax.eval_shape(lambda k, *a: fnn.Module.init(self, k, *a, **kw), key,
                                          *args)
        tree = jax.tree_util.tree_map_with_path(lambda p, s: _fill(p, s, rng), _SHAPES[tag])
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32).astype(dtype)),
                            dict(tree))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer.ReIDClassifier, "init", init)
        return jtrainer.ReIDTrainer(cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    a = np.asarray(tree)
    if path[-1] == "kernel":
        a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
    return a


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


def _kw(name, steps=8):
    return dict(model=name, data_root=str(FIXTURE), crop_hw=HW, p=2, k=2, steps=steps,
                warmup_steps=2, seed=0)


def _load_jax_state(tt, jt):
    """The JAX trainer's parameters, batch statistics, Adam state, EMA and
    step, into the port's."""
    variables = {"params": _np(jt.params), "batch_stats": _np(jt.batch_stats)}
    tt.model.load_state_dict(tconvert.state_dict_from_flax_paths(tt.model, tt.cfg.model, variables))
    adam = _adam(jt.opt_state)
    tt.opt.count = int(adam.count)
    ema = _np(jt.ema_params)
    for path in tt.params:
        parts = path.split("/")
        tt.opt.mu[path] = torch.from_numpy(np.array(_leaf(adam.mu, parts)))
        tt.opt.nu[path] = torch.from_numpy(np.array(_leaf(adam.nu, parts)))
        tt.ema_params[path].copy_(torch.from_numpy(np.array(_leaf(ema, parts))))
    tt.step = jt.step


def _compare(tt, jt, lr_sum, grad_rms, outlier_share=0.0):
    """Parameters (and EMA) within 1e-4 but for ``outlier_share`` of the
    elements and the rounding-noise tensors (Adam's bound ``2 lr_sum``),
    batch statistics within 1e-4."""
    sd = tt.model.state_dict()
    variables = {"params": _np(jt.params), "batch_stats": _np(jt.batch_stats)}
    ema = _np(jt.ema_params)
    gmax = max(float(np.abs(g).max()) for g in grad_rms.values())
    over = total = 0
    for key, (coll, *path) in tconvert.flax_paths(tt.model, tt.cfg.model).items():
        want = _leaf(variables[coll], path)
        if coll == "batch_stats":
            np.testing.assert_allclose(sd[key].numpy(), want, rtol=0, atol=1e-4, err_msg=key)
            continue
        p = "/".join(path)
        bound = 2 * lr_sum * tt.lr_scales[p] + 1e-6
        for got, ref in ((sd[key].numpy(), want), (tt.ema_params[p].numpy(), _leaf(ema, path))):
            d = np.abs(got - ref)
            assert d.max() <= bound, (key, d.max(), bound)
            if np.sqrt(np.mean(grad_rms[p] ** 2)) >= 1e-6 * gmax:
                over += int((d > 1e-4).sum())
                total += d.size
    assert over <= outlier_share * total, (over, total)


def _grad_rms(jt, parts_of):
    """Each parameter's gradient RMS so far, from JAX's Adam state."""
    adam = _adam(jt.opt_state)
    corr = 1 - 0.999 ** int(adam.count)
    return {p: np.sqrt(_leaf(adam.nu, parts) / corr) for p, parts in parts_of.items()}


def test_trainer_equals_jax_vit_nano():
    """vit_nano, AdamW + clip 1.0 + layer decay: 4 steps uninterrupted."""
    cfg = jtrainer.TrainConfig(**_kw("vit_nano"))
    jt = jax_trainer(cfg)
    tt = ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("vit_nano")), device="cpu",
                              variables={"params": _np(jt.params),
                                         "batch_stats": _np(jt.batch_stats)})
    assert tt.opt.opt == "adamw" and tt.opt.grad_clip == 1.0
    assert tt.lr_scales["backbone/block0/fc1/kernel"] == pytest.approx(0.95 ** 6)
    want, got = jt.fit(steps=4, log_every=1), tt.fit(steps=4, log_every=1)
    for w, g in zip(want, got):
        for k in ("loss", "ce", "triplet"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), (w, g)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    lr_sum = sum(tt.schedule(s) for s in range(4))
    _compare(tt, jt, lr_sum, _grad_rms(jt, {p: p.split("/") for p in tt.params}))
    # the ranking eval of the EMA weights: the same numbers
    want_eval, got_eval = jt.evaluate(), tt.evaluate()
    assert got_eval.keys() == want_eval.keys()
    for k in want_eval:
        assert got_eval[k] == pytest.approx(want_eval[k], abs=1e-6), k


def test_trainer_steps_equal_jax_osnet():
    """osnet_x0_25, Adam with L2: each of 4 steps from the JAX trainer's state."""
    cfg = jtrainer.TrainConfig(**_kw("osnet_x0_25"))
    jt = jax_trainer(cfg)
    tt = ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("osnet_x0_25")), device="cpu",
                              variables={"params": _np(jt.params),
                                         "batch_stats": _np(jt.batch_stats)})
    assert tt.opt.opt == "adam" and tt.opt.grad_clip == 0.0
    # the no-WD set follows the Flax names: fc_bn (OSNet's "fc.1") decays not
    assert not tt.opt.decay["backbone/fc_bn/scale"] and tt.opt.decay["backbone/fc/kernel"]
    for _ in range(4):
        _load_jax_state(tt, jt)
        lr = tt.schedule(tt.step)
        images, labels = jt._next_batch()
        out = jt._train_step(jt.params, jt.batch_stats, jt.opt_state, jt.ema_params,
                             jnp.asarray(images), jnp.asarray(labels),
                             jnp.asarray(jt.step, jnp.int32))
        jt.params, jt.batch_stats, jt.opt_state, jt.ema_params = out[:4]
        jt.step += 1
        loss, ce, tri = tt._train_step(*tt._next_batch())
        for g, w in zip((loss, ce, tri), out[4:]):
            assert float(g) == pytest.approx(float(w), rel=1e-4)
        _compare(tt, jt, lr, _grad_rms(jt, {p: p.split("/") for p in tt.params}),
                 outlier_share=1e-3)


def test_trainer_equals_jax_osnet_float64():
    """osnet_x0_25, Adam with L2, in float64 in both packages: 4 steps
    uninterrupted agree far inside the float32 tolerances, so the float32
    test's gaps are rounding, amplified, and not the port's."""
    with jax.enable_x64(True):
        jt = jax_trainer(jtrainer.TrainConfig(**_kw("osnet_x0_25")), dtype=np.float64)
        assert jax.tree_util.tree_leaves(jt.params)[0].dtype == jnp.float64
        tt = ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("osnet_x0_25")), device="cpu",
                                  variables={"params": _np(jt.params),
                                             "batch_stats": _np(jt.batch_stats)},
                                  dtype=torch.float64)
        _assert_float64_equal(tt, jt, 4)


def _assert_float64_equal(tt, jt, steps):
    """``steps`` logged steps of both trainers: losses within rtol 1e-10;
    parameters, batch statistics, Adam's moments and EMA within 1e-8."""
    want, got = jt.fit(steps=steps, log_every=1), tt.fit(steps=steps, log_every=1)
    assert len(want) == len(got) == steps
    for w, g in zip(want, got):
        for k in ("loss", "ce", "triplet"):
            assert g[k] == pytest.approx(w[k], rel=1e-10), (k, w, g)
    sd = tt.model.state_dict()
    variables = {"params": _np(jt.params), "batch_stats": _np(jt.batch_stats)}
    adam, ema = _adam(jt.opt_state), _np(jt.ema_params)
    for key, (coll, *path) in tconvert.flax_paths(tt.model, tt.cfg.model).items():
        assert sd[key].dtype == tt.opt.mu["backbone/conv1/conv/kernel"].dtype == torch.float64
        np.testing.assert_allclose(sd[key].numpy(), _leaf(variables[coll], path), rtol=0,
                                   atol=1e-8, err_msg=key)
        if coll == "params":
            p = "/".join(path)
            for got_t, tree in ((tt.opt.mu[p], adam.mu), (tt.opt.nu[p], adam.nu),
                                (tt.ema_params[p], ema)):
                np.testing.assert_allclose(got_t.numpy(), _leaf(tree, path), rtol=0,
                                           atol=1e-8, err_msg=key)


def test_sharded_trainer_equals_jax_sharded_osnet_float64():
    """osnet_x0_25 in float64, ``n_devices=2``: the port over the mesh
    ("cpu", "cpu") against the JAX trainer over two of the suite's virtual
    devices, one step from the same variables."""
    with jax.enable_x64(True):
        jt = jax_trainer(jtrainer.TrainConfig(**_kw("osnet_x0_25"), n_devices=2),
                         dtype=np.float64)
        assert jt.mesh is not None and jt.mesh.devices.size == 2
        tt = ttrainer.ReIDTrainer(ttrainer.TrainConfig(**_kw("osnet_x0_25"), n_devices=2),
                                  device=("cpu", "cpu"),
                                  variables={"params": _np(jt.params),
                                             "batch_stats": _np(jt.batch_stats)},
                                  dtype=torch.float64)
        assert tt.mesh == (torch.device("cpu"),) * 2
        _assert_float64_equal(tt, jt, 1)
