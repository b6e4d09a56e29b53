"""The ReID trainer on the card: P x K batches, CE + metric loss, the
optimizer profiles, warmup-cosine LR, EMA, checkpoints and resume.

Counterpart of ``boxmot_tpu/reid/training/trainer.py`` (``TrainConfig``,
``ReIDClassifier``, ``make_schedule``, ``ReIDTrainer``).  One step: the
batch of ``P x K`` augmented crops (host numpy, ``reid/datasets.py``, with
the per-step generator ``default_rng((seed, step))`` so that a resumed run
draws the same data) goes to ``device`` once; the model runs in train mode
with Flax's batch-norm statistics (``models/layers.py::
use_flax_batch_norm``: momentum 0.99, biased variance); the loss is ``ce_w
* CE + metric_w * metric (+ center_w * center)``, the JAX step's; the
gradients go through ``ProfileOptimizer`` (optax's semantics) and the
per-parameter scales (layer decay, or the freeze / warmup windows); the EMA
follows.  No host read in a step but at its log lines.

Parameters are keyed by their Flax paths (``models/convert.py::
flax_paths``), so the trainer can start from the JAX package's Flax
variables of ``ReIDClassifier`` (``variables=``), and its masks and scales
equal the JAX trainer's leaf for leaf; without them the model starts from
PyTorch's initialization under ``torch.manual_seed(cfg.seed)`` (the global
generator left as it was).  Checkpoints are the port's own (``torch.save``
of the model's state, the optimizer's moments and count, the EMA, the step
and the history); the JAX package's pickles do not load.  ``n_devices > 1``
(the JAX trainer's data-parallel mesh) is not ported: it raises the JAX
trainer's ``ValueError`` when fewer cards are present, else
``NotImplementedError``.  ``dtype=torch.float64`` trains in double (model,
moments, EMA and batches), to tell float32 rounding from a fault; a
checkpoint loads into either.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from boxmot_tpu_torch.models.convert import flax_paths, state_dict_from_flax_paths
from boxmot_tpu_torch.models.layers import use_flax_batch_norm
from boxmot_tpu_torch.reid.datasets import PKSampler, load_dataset, make_batch
from boxmot_tpu_torch.reid.training import losses as L
from boxmot_tpu_torch.reid.training import optim as O
from boxmot_tpu_torch.utils.device import resolve_device

METRIC_LOSSES = ("triplet", "ms", "multi_similarity", "circle", "softmax")
CLASSIFIER_LOSSES = ("ce", "arcface", "cosface")


@dataclasses.dataclass
class TrainConfig:
    model: str = "osnet_x0_25"
    dataset: str = "market1501"
    data_root: str = ""
    crop_hw: tuple = (256, 128)
    p: int = 4  # identities per batch
    k: int = 4  # instances per identity
    steps: int = 1000
    warmup_steps: int = 100
    epochs: int = 0  # > 0: steps and warmup_steps from the dataset's size
    warmup_epochs: int = 0
    base_lr: float = 3.5e-4
    weight_decay: float = 5e-4
    optimizer: str = ""  # '' / -1: by backbone family (optim.resolve_profile)
    grad_clip: float = -1.0
    vit_lr_profile: str = "layer_decay"  # layer_decay | reid_lrd | none
    layer_decay: float = 0.95
    head_warmup_epochs: int = 0
    head_warmup_lr_mult: float = 2.0
    backbone_freeze_epochs: int = 0
    center_lr: float = 0.5  # the center head's own SGD LR
    loss: str = "triplet"  # metric loss: triplet | ms | circle | softmax
    soft_margin: bool = False
    triplet_margin: float = 0.3
    triplet_weight: float = 1.0
    ce_weight: float = 1.0
    label_smooth: float = 0.1
    center_loss_weight: float = 0.0
    classifier_loss: str = "ce"  # ce | arcface | cosface
    arcface_scale: float = 30.0
    arcface_margin: float = 0.5
    cosface_scale: float = 30.0
    cosface_margin: float = 0.35
    aux_ce_weight: float = 1.0
    aux_ce_drop_epoch: int = 0
    ema_decay: float = 0.999
    random_erasing: float = 0.5
    color_jitter: bool = False
    gaussian_blur: bool = False
    random_grayscale: float = 0.0
    eval_interval: int = 0
    flip_tta: bool = False
    seed: int = 0
    ckpt_dir: str = ""
    n_devices: int = 0

    def aug_kwargs(self) -> dict:
        return {"erase_p": self.random_erasing, "color_jitter": self.color_jitter,
                "gaussian_blur": self.gaussian_blur, "grayscale_p": self.random_grayscale}


class ReIDClassifier(nn.Module):
    """Backbone + identity head (+ center head), the Flax module's names.

    The second output is the identity-loss input: logits for ``ce``, a tuple
    of per-segment logits when the backbone has ``part_dims``, or the
    margin head's loss for arcface / cosface."""

    def __init__(self, backbone: nn.Module, num_classes: int, center: bool = False,
                 classifier_loss: str = "ce", margin_scale: float = 30.0,
                 margin_margin: float = 0.5, part_dims: tuple = ()):
        super().__init__()
        self.backbone, self.classifier_loss, self.part_dims = backbone, classifier_loss, part_dims
        dim = backbone.feature_dim
        if classifier_loss == "arcface":
            self.margin_head = L.ArcFaceHead(dim, num_classes, margin_scale, margin_margin)
        elif classifier_loss == "cosface":
            self.margin_head = L.CosFaceHead(dim, num_classes, margin_scale, margin_margin)
        elif len(part_dims) > 1:
            for i, d in enumerate(part_dims):
                setattr(self, f"classifier{i}", nn.Linear(d, num_classes))
        else:
            self.classifier = nn.Linear(dim, num_classes)
        if center:
            self.center = L.CenterHead(num_classes, dim)

    def forward(self, x, targets):
        feats = self.backbone(x)
        if self.classifier_loss in ("arcface", "cosface"):
            id_out = self.margin_head(feats, targets)
        elif len(self.part_dims) > 1:
            segs = torch.split(feats, list(self.part_dims), dim=1)
            id_out = tuple(getattr(self, f"classifier{i}")(s) for i, s in enumerate(segs))
        else:
            id_out = self.classifier(feats)
        if hasattr(self, "center"):
            return feats, id_out, self.center(feats, targets)
        return feats, id_out


def make_schedule(cfg: TrainConfig):
    """optax's warmup-cosine from base_lr / 25 to base_lr, decaying to
    base_lr / 1000 at ``steps``."""
    return O.warmup_cosine(cfg.base_lr, cfg.warmup_steps, cfg.steps)


def _slash(path) -> str:
    return "/".join(path)


class ReIDTrainer:
    def __init__(self, cfg: TrainConfig, device="cuda", variables: dict | None = None,
                 dtype: torch.dtype = torch.float32):
        if cfg.loss not in METRIC_LOSSES:
            raise ValueError(f"unknown metric loss {cfg.loss!r}; supported: {METRIC_LOSSES}")
        if cfg.classifier_loss not in CLASSIFIER_LOSSES:
            raise ValueError(f"unknown classifier loss {cfg.classifier_loss!r}; "
                             f"supported: {CLASSIFIER_LOSSES}")
        self.device = resolve_device(device)
        self.dataset = load_dataset(cfg.dataset, cfg.data_root)
        self.num_classes = self.dataset.num_train_pids
        batch = min(cfg.p, self.num_classes) * cfg.k
        spe = max(1, len(self.dataset.train) // batch)
        if cfg.loss in ("ms", "multi_similarity") and cfg.center_loss_weight > 0:
            cfg = dataclasses.replace(cfg, center_loss_weight=0.0)
        if cfg.epochs > 0:
            cfg = dataclasses.replace(cfg, steps=cfg.epochs * spe,
                                      warmup_steps=cfg.warmup_epochs * spe)
        if cfg.n_devices and cfg.n_devices > 1:
            present = torch.cuda.device_count() if self.device.type == "cuda" else 1
            if present < cfg.n_devices:
                raise ValueError(f"n_devices={cfg.n_devices} but only {present} present")
            raise NotImplementedError("data-parallel training over several cards is not ported: "
                                      "it is what remains of ROADMAP Queue A item 23 "
                                      "(parallel/replay.py is ported over one card)")
        self.cfg = cfg
        from boxmot_tpu_torch.reid.core import MODEL_NAMES, build_model  # noqa: PLC0415

        if cfg.model not in MODEL_NAMES:
            raise ValueError(f"unknown ReID model {cfg.model!r}; available: {sorted(MODEL_NAMES)}")
        scale, margin = {"ce": (0.0, 0.0), "arcface": (cfg.arcface_scale, cfg.arcface_margin),
                         "cosface": (cfg.cosface_scale, cfg.cosface_margin)}[cfg.classifier_loss]
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            backbone = build_model(cfg.model, cfg.crop_hw)
            model = ReIDClassifier(backbone, self.num_classes, center=cfg.center_loss_weight > 0,
                                   classifier_loss=cfg.classifier_loss, margin_scale=scale,
                                   margin_margin=margin,
                                   part_dims=tuple(getattr(backbone, "part_dims", ()) or ()))
        use_flax_batch_norm(model)
        if variables is not None:
            model.load_state_dict(state_dict_from_flax_paths(model, cfg.model, variables))
        self.dtype = dtype
        self.model = model.to(self.device, dtype)
        self.sampler = PKSampler(self.dataset.train, cfg.p, cfg.k, seed=cfg.seed)
        self.schedule = make_schedule(cfg)

        # parameters by Flax path ("backbone/block0/attn/qkv/kernel")
        named = dict(self.model.named_parameters())
        self.paths = {k: _slash(p[1:]) for k, p in flax_paths(self.model, cfg.model).items()
                      if p[0] == "params"}
        self.params = {self.paths[k]: named[k] for k in self.paths}
        for k, t in named.items():  # a parameter Flax lacks must not train
            if k not in self.paths:
                raise ValueError(f"parameter {k} has no Flax counterpart")
        opt_name, grad_clip = O.resolve_profile(cfg.optimizer, cfg.grad_clip, cfg.model)
        self.opt = O.ProfileOptimizer(self.params, opt_name, grad_clip, self.schedule,
                                      cfg.weight_decay, cfg.center_loss_weight, cfg.center_lr)
        vit = O.is_vit_model(cfg.model)
        self.lr_scales = O.lr_scales(list(self.params), cfg.vit_lr_profile if vit else "none",
                                     cfg.layer_decay)
        self.freeze_scales, self.warmup_scales = O.window_scales(list(self.params),
                                                                 cfg.head_warmup_lr_mult)
        self._head_warmup_steps = cfg.head_warmup_epochs * spe if vit else 0
        self._backbone_freeze_steps = cfg.backbone_freeze_epochs * spe
        self._aux_drop_steps = cfg.aux_ce_drop_epoch * spe
        self._spe = spe
        self.best_map = -1.0
        self.ema_params = {p: t.detach().clone() for p, t in self.params.items()}
        self.step = 0
        self.history = []

    # -- one step ------------------------------------------------------

    def _losses(self, images, labels):
        cfg, step = self.cfg, self.step
        out = self.model(images, labels)
        feats, id_out = out[0], out[1]
        if cfg.classifier_loss != "ce":
            ce = id_out
        elif isinstance(id_out, tuple):
            parts = [L.cross_entropy_label_smooth(lg, labels, cfg.label_smooth) for lg in id_out]
            aux_w = cfg.aux_ce_weight
            if self._aux_drop_steps > 0 and step >= self._aux_drop_steps:
                aux_w = 0.0
            ce = (parts[0] + aux_w * sum(parts[1:])) / (1.0 + aux_w * (len(parts) - 1))
        else:
            ce = L.cross_entropy_label_smooth(id_out, labels, cfg.label_smooth)
        if cfg.loss in ("ms", "multi_similarity"):
            tri = L.multi_similarity_loss(feats, labels)
        elif cfg.loss == "circle":
            tri = L.circle_loss(feats, labels)
        elif cfg.loss == "softmax":
            tri = torch.zeros((), device=feats.device)
        else:
            tri = L.triplet_loss(feats, labels, cfg.triplet_margin, soft_margin=cfg.soft_margin)
        loss = cfg.ce_weight * ce + cfg.triplet_weight * tri
        if cfg.center_loss_weight > 0:
            # the center term pauses only during head warmup
            hw_active = step < self._head_warmup_steps and step >= self._backbone_freeze_steps
            loss = loss + (0.0 if hw_active else cfg.center_loss_weight) * out[2]
        return loss, ce, tri

    def _train_step(self, images, labels):
        self.model.train()
        loss, ce, tri = self._losses(images, labels)
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(loss, [self.params[p] for p in names],
                                                    allow_unused=True)))
        grads = {p: torch.zeros_like(self.params[p]) if g is None else g for p, g in grads.items()}
        updates = self.opt.update(grads, self.params)
        bf_active = self.step < self._backbone_freeze_steps
        hw_active = self.step < self._head_warmup_steps and not bf_active
        scales = (self.freeze_scales if bf_active else self.warmup_scales if hw_active
                  else self.lr_scales)
        d = self.cfg.ema_decay
        with torch.no_grad():
            for p, u in updates.items():
                self.params[p].add_(u * scales[p])
                self.ema_params[p].mul_(d).add_((1 - d) * self.params[p])
        return loss.detach(), ce.detach(), tri.detach()

    # -- checkpointing -------------------------------------------------

    def save_checkpoint(self, path: Path | None = None) -> Path:
        path = Path(path or Path(self.cfg.ckpt_dir) / f"ckpt_{self.step}.pt")
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step,
                    "model": {k: v.cpu() for k, v in self.model.state_dict().items()},
                    "opt": self.opt.state_dict(),
                    "ema_params": {p: t.cpu() for p, t in self.ema_params.items()},
                    "history": self.history, "best_map": self.best_map,
                    "cfg": dataclasses.asdict(self.cfg)}, path)
        return path

    def load_checkpoint(self, path: Path) -> None:
        state = torch.load(path, map_location="cpu", weights_only=False)
        self.step = state["step"]
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        for p, t in state["ema_params"].items():
            self.ema_params[p].copy_(t)
        self.history = state["history"]
        self.best_map = state.get("best_map", -1.0)

    # -- training ------------------------------------------------------

    def _next_batch(self):
        rng = np.random.default_rng((self.cfg.seed, self.step))
        self.sampler.rng = rng
        idxs = self.sampler.sample_batch()
        images, labels = make_batch(self.dataset.train, idxs, self.cfg.crop_hw, rng=rng,
                                    train=True, aug_kwargs=self.cfg.aug_kwargs())
        images = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
        return (images.to(self.device, self.dtype),
                torch.from_numpy(labels).long().to(self.device))

    def evaluate(self, rerank: bool = False) -> dict:
        """CMC / mAP on the dataset's query and gallery with the EMA weights."""
        from boxmot_tpu_torch.reid.training.evaluator import evaluate_reid  # noqa: PLC0415

        return evaluate_reid(self.inference_backbone(ema=True), self.dataset, hw=self.cfg.crop_hw,
                             rerank=rerank, flip_tta=self.cfg.flip_tta, device=self.device)

    def _maybe_eval(self, verbose: bool) -> None:
        res = self.evaluate()
        rec = {"step": self.step, **{k: round(v, 4) for k, v in res.items()}}
        self.history.append(rec)
        if verbose:
            print(rec)
        if res["mAP"] > self.best_map:
            self.best_map = res["mAP"]
            if self.cfg.ckpt_dir:
                self.save_checkpoint(Path(self.cfg.ckpt_dir) / "best.pt")

    def fit(self, steps: int | None = None, log_every: int = 50, verbose: bool = False):
        steps = steps if steps is not None else self.cfg.steps
        eval_every = self.cfg.eval_interval * self._spe
        t0 = time.perf_counter()
        while self.step < steps:
            loss, ce, tri = self._train_step(*self._next_batch())
            self.step += 1
            if self.step % log_every == 0 or self.step == steps:
                rec = {"step": self.step, "loss": float(loss), "ce": float(ce),
                       "triplet": float(tri), "lr": float(np.float32(self.schedule(self.step))),
                       "seconds": round(time.perf_counter() - t0, 1)}
                self.history.append(rec)
                if verbose:
                    print(rec)
            if eval_every and self.step % eval_every == 0:
                self._maybe_eval(verbose)
        if eval_every and steps % eval_every != 0:
            self._maybe_eval(verbose)
        if self.cfg.ckpt_dir:
            self.save_checkpoint()
        return self.history

    # -- inference weights ---------------------------------------------

    def backbone_variables(self, ema: bool = True) -> dict:
        """The backbone's state dict (the port's keys) with the EMA (or the
        live) parameters and the batch statistics, for ``ReID``'s model."""
        params = self.ema_params if ema else self.params
        sd = {k: v.detach().clone() for k, v in self.model.backbone.state_dict().items()}
        for k, path in self.paths.items():
            if k.startswith("backbone."):
                sd[k.removeprefix("backbone.")] = params[path].detach().clone()
        return sd

    def inference_backbone(self, ema: bool = True) -> nn.Module:
        """A copy of the backbone in eval mode with ``backbone_variables``."""
        backbone = copy.deepcopy(self.model.backbone).eval()
        backbone.load_state_dict(self.backbone_variables(ema))
        return backbone
