"""CLIP-ReID stage-1 prompt learning on the card.

Counterpart of ``boxmot_tpu/reid/training/clip_prompt.py``
(``PromptStageConfig``, ``PromptStage``, ``learn_identity_prompts``): the
image features of the training set are fixed; per-identity context
vectors (and, from scratch, the template and the text tower) learn against
them with the symmetric supervised contrastive loss
(``models/clip_reid.py::clip_prompt_losses``).  The JAX ``lax.scan`` over
the pre-sampled index stream is a Python loop here, each step one text
forward and backward on ``device``; ``optax.adam`` is
``optim.ProfileOptimizer`` with AdamW at weight decay 0 and a constant LR
(optax's Adam).  ``pretrained=`` takes the port's ``convert_clip`` output:
the text tower loads it and stays frozen, the template is embedded with its
token embeddings through the port's tokenizer, and only the context
vectors train.  ``params=`` starts ``prompt`` and / or ``text`` from given
parameters, as Flax trees of numpy arrays (parts of the JAX
``PromptStage.init`` output), instead of PyTorch's initialization under
``torch.manual_seed(cfg.seed)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from boxmot_tpu_torch.models.clip_reid import (
    ClipTextEncoder,
    PromptLearner,
    clip_prompt_losses,
    pretrained_prompt_template,
)
from boxmot_tpu_torch.models.convert import state_dict_from_flax_paths
from boxmot_tpu_torch.reid.training.optim import ProfileOptimizer
from boxmot_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PromptStageConfig:
    num_classes: int
    feat_dim: int = 512
    width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    n_cls_ctx: int = 4
    batch: int = 64
    steps: int = 200
    lr: float = 3.5e-4
    temperature: float = 0.07
    seed: int = 0


class PromptStage(torch.nn.Module):
    """``PromptLearner`` (``prompt``) and ``ClipTextEncoder`` (``text``)."""

    def __init__(self, cfg: PromptStageConfig, n_prefix: int = 5, n_suffix: int = 2,
                 text_context: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.prompt = PromptLearner(cfg.num_classes, cfg.width, n_prefix=n_prefix,
                                    n_cls_ctx=cfg.n_cls_ctx, n_suffix=n_suffix)
        self.text = ClipTextEncoder(cfg.width, cfg.text_layers, cfg.text_heads,
                                    context=text_context or self.prompt.seq_len,
                                    proj_dim=cfg.feat_dim)

    def encode(self, labels):
        return self.text(self.prompt(labels), self.prompt.eot_index)


def learn_identity_prompts(image_feats: np.ndarray, labels: np.ndarray,
                           cfg: PromptStageConfig | None = None, train_text: bool = False,
                           pretrained: dict | None = None,
                           template: str = "A photo of a X X X X person.",
                           params: dict | None = None, device="cuda"):
    """Stage 1: returns (stage, params, losses): the trained ``PromptStage``
    on ``device``, its ``{"prompt", "text"}`` state dicts (on the CPU) and
    the loss of every step (numpy)."""
    device = resolve_device(device)
    cfg = cfg or PromptStageConfig(num_classes=int(labels.max()) + 1)
    if pretrained is not None:
        if train_text:
            raise ValueError("pretrained text tower trains frozen")
        tc, tok_emb = pretrained["text_config"], pretrained["token_embedding"]
        cfg = dataclasses.replace(cfg, width=int(tok_emb.shape[1]),
                                  text_heads=max(1, int(tok_emb.shape[1]) // 64),
                                  text_layers=tc["layers"], feat_dim=tc["proj_dim"])
        prefix, suffix, _ = pretrained_prompt_template(tok_emb, template, cfg.n_cls_ctx)
        n_prefix, n_suffix, context = len(prefix), len(suffix), tc["context"]
    else:
        n_prefix, n_suffix, context = 5, 2, None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        stage = PromptStage(cfg, n_prefix, n_suffix, context)
    for name, tree in (params or {}).items():  # "prompt" and / or "text"
        module = getattr(stage, name)
        module.load_state_dict(state_dict_from_flax_paths(module, "clip", {"params": tree}))
    if pretrained is not None:
        stage.text.load_state_dict(pretrained["text"])
        with torch.no_grad():
            stage.prompt.token_prefix.copy_(torch.from_numpy(prefix))
            stage.prompt.token_suffix.copy_(torch.from_numpy(suffix))
    stage = stage.to(device)

    if pretrained is not None:  # only the identities' context vectors move
        trainable = {"prompt/cls_ctx": stage.prompt.cls_ctx}
    else:
        modules = (("prompt", stage.prompt), ("text", stage.text)) if train_text else \
            (("prompt", stage.prompt),)
        trainable = {f"{m}/{k}": p for m, mod in modules for k, p in mod.named_parameters()}
    opt = ProfileOptimizer(trainable, "adamw", 0.0, lambda _: cfg.lr, 0.0)

    feats = torch.as_tensor(np.asarray(image_feats, np.float32), device=device)
    labs = torch.as_tensor(np.asarray(labels), dtype=torch.long, device=device)
    n = feats.shape[0]
    batch = min(cfg.batch, n)
    idx_stream = np.random.default_rng(cfg.seed).integers(0, n, size=(cfg.steps, batch))
    idx_stream = torch.as_tensor(idx_stream, dtype=torch.long, device=device)
    names = list(trainable)
    losses = []
    for idxs in idx_stream:
        loss = clip_prompt_losses(feats[idxs], stage.encode(labs[idxs]), labs[idxs],
                                  cfg.temperature)
        grads = dict(zip(names, torch.autograd.grad(loss, [trainable[p] for p in names])))
        with torch.no_grad():
            for p, u in opt.update(grads, trainable).items():
                trainable[p].add_(u)
        losses.append(loss.detach())
    out = {name: {k: v.detach().cpu() for k, v in getattr(stage, name).state_dict().items()}
           for name in ("prompt", "text")}
    return stage, out, torch.stack(losses).cpu().numpy()
