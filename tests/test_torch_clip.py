"""The port's CLIP-ReID (``models/clip_reid.py``, ``models/clip_tokenizer.py``,
``models/convert.py::convert_clip``, ``reid/training/clip_prompt.py``)
against the JAX package's, on the CPU.

A seeded tiny CLIP state dict in OpenAI's key naming (both towers 64 wide, 2
layers, one 64-wide head, a 32-d shared space, the real 49,408-token
vocabulary so that the template's ids index it, a 14 x 14 image grid that
``convert_clip`` resamples to 16 x 8), and the same weights in CLIP-ReID's
fine-tune naming (``image_encoder.*``, ``text_encoder.*``, BNNecks,
``prompt_learner.cls_ctx``).  Tolerances:

* token ids equal; the positional-embedding resample within 1e-6 (JAX's
  antialiased ``jax.image.resize`` against the port's numpy matrices);
* converted weights within 1e-6; image features and text outputs within
  1e-5 of their largest absolute value; ``clip_prompt_losses`` within 1e-6;
* ``learn_identity_prompts`` from the JAX ``PromptStage.init``'s parameters:
  every step's loss within rtol 1e-5 and the context vectors after the last
  step within 1e-5 (Adam's first step turns a gradient's rounding into its
  sign, so these stay at steps whose gradients are far from 0).
"""

from __future__ import annotations

import dataclasses
import random
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boxmot_tpu.models import clip_reid as jclip
from boxmot_tpu.models import clip_tokenizer as jtok
from boxmot_tpu.models import convert as jconvert
from boxmot_tpu.reid.training import clip_prompt as jprompt
from boxmot_tpu_torch.models import clip_reid as tclip
from boxmot_tpu_torch.models import clip_tokenizer as ttok
from boxmot_tpu_torch.models import convert as tconvert
from boxmot_tpu_torch.reid import ReID
from boxmot_tpu_torch.reid.training import clip_prompt as tprompt

W, LAYERS, EMB, VOCAB, CTX, P, GRID = 64, 2, 32, 49408, 20, 16, 14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs under several xdist workers
    yield
    torch.set_num_threads(prev)


def _blocks(rng, prefix):
    sd = {}
    for i in range(LAYERS):
        b = f"{prefix}transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"] = rng.normal(1, 0.05, W)
            sd[f"{b}.{ln}.bias"] = rng.normal(0, 0.05, W)
        sd[f"{b}.attn.in_proj_weight"] = rng.normal(0, 0.1, (3 * W, W))
        sd[f"{b}.attn.in_proj_bias"] = rng.normal(0, 0.05, 3 * W)
        sd[f"{b}.attn.out_proj.weight"] = rng.normal(0, 0.1, (W, W))
        sd[f"{b}.attn.out_proj.bias"] = rng.normal(0, 0.05, W)
        sd[f"{b}.mlp.c_fc.weight"] = rng.normal(0, 0.1, (4 * W, W))
        sd[f"{b}.mlp.c_fc.bias"] = rng.normal(0, 0.05, 4 * W)
        sd[f"{b}.mlp.c_proj.weight"] = rng.normal(0, 0.05, (W, 4 * W))
        sd[f"{b}.mlp.c_proj.bias"] = rng.normal(0, 0.05, W)
    return sd


def tiny_clip(seed=0) -> dict:
    """A seeded OpenAI-format CLIP state dict (numpy float32)."""
    rng = np.random.default_rng(seed)
    sd = {"visual.conv1.weight": rng.normal(0, 0.05, (W, 3, P, P)),
          "visual.class_embedding": rng.normal(0, 0.1, W),
          "visual.positional_embedding": rng.normal(0, 0.1, (1 + GRID * GRID, W)),
          "visual.ln_pre.weight": rng.normal(1, 0.05, W), "visual.ln_pre.bias": rng.normal(0, 0.05, W),
          "visual.ln_post.weight": rng.normal(1, 0.05, W),
          "visual.ln_post.bias": rng.normal(0, 0.05, W),
          "visual.proj": rng.normal(0, 0.1, (W, EMB)),
          "token_embedding.weight": rng.normal(0, 0.1, (VOCAB, W)),
          "positional_embedding": rng.normal(0, 0.05, (CTX, W)),
          "ln_final.weight": rng.normal(1, 0.05, W), "ln_final.bias": rng.normal(0, 0.05, W),
          "text_projection": rng.normal(0, 0.1, (W, EMB)), "logit_scale": np.float32(4.6),
          **_blocks(rng, "visual."), **_blocks(rng, "")}
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def finetune_naming(sd: dict, seed=1) -> dict:
    """The same weights under CLIP-ReID's keys, with BNNecks and identity
    contexts."""
    rng = np.random.default_rng(seed)
    ft = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            ft["image_encoder." + k.removeprefix("visual.")] = v
        elif k != "logit_scale":
            ft["text_encoder." + k] = v
        else:
            ft[k] = v
    for neck, dim in (("bottleneck", W), ("bottleneck_proj", EMB)):
        ft[f"{neck}.weight"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
        ft[f"{neck}.bias"] = np.zeros(dim, np.float32)
        ft[f"{neck}.running_mean"] = rng.normal(0, 0.1, dim).astype(np.float32)
        ft[f"{neck}.running_var"] = rng.uniform(0.5, 1.5, dim).astype(np.float32)
    ft["prompt_learner.cls_ctx"] = rng.normal(0, 0.02, (5, 4, W)).astype(np.float32)
    ft["prompt_learner.token_prefix"] = np.zeros((1, 5, W), np.float32)
    ft["classifier.weight"] = np.zeros((5, W + EMB), np.float32)
    return ft


TEXTS = ["A photo of a X X X X person.", "a photo of a person.",
         "Héllo wörld! it's 2024, naïve café — 東京 ünïcödé <|endoftext|>",
         "don't STOP!!'s  tabs\tand\nnewlines 123abc ½ ² ⅷ", "&amp;lt;b&gt; emoji 😀👍🏽 x-ray",
         "!<|endoftext|>", "'LL 'll'VE ''s", "Ωmega αβγ ÇA ͅx \x1c"]


def test_tokenizer_ids_equal_jax():
    """Templates, non-ASCII text and 300 seeded strings of assigned code
    points: the port's scanner splits words as the JAX package's ``regex``
    pattern does, so the ids are equal; the vocabulary file is byte-identical."""
    assert ttok.VOCAB_PATH.read_bytes() == jtok.VOCAB_PATH.read_bytes()
    rng = random.Random(0)
    fuzz = []
    for _ in range(300):
        s = "".join(chr(rng.choice([rng.randint(32, 126), rng.randint(0xA0, 0x3000),
                                    rng.randint(0x1F300, 0x1F6FF)]))
                    for _ in range(rng.randint(1, 24)))
        fuzz.append("".join(c for c in s if unicodedata.category(c) != "Cn"))
    for text in [*TEXTS, *fuzz]:
        assert ttok.get_tokenizer().encode(text) == jtok.get_tokenizer().encode(text), text
    np.testing.assert_array_equal(ttok.tokenize(TEXTS), jtok.tokenize(TEXTS))
    np.testing.assert_array_equal(ttok.tokenize(TEXTS[2] * 9, truncate=True),
                                  jtok.tokenize(TEXTS[2] * 9, truncate=True))
    with pytest.raises(ValueError, match="context_length"):
        ttok.tokenize(TEXTS[2] * 9)
    assert ttok.get_tokenizer().decode(ttok.tokenize(TEXTS[0])[0][1:12]) == \
        jtok.get_tokenizer().decode(jtok.tokenize(TEXTS[0])[0][1:12])


@pytest.mark.parametrize("src,dst", [(14, (16, 8)), (14, (16, 16)), (7, (4, 4)), (4, (4, 4))])
def test_resize_pos_embed_equals_jax(src, dst):
    pos = np.random.default_rng(src).normal(size=(1 + src * src, 12)).astype(np.float32)
    want = jconvert._resize_clip_pos_embed(pos, *dst)
    got = tconvert._resize_clip_pos_embed(pos, *dst)
    assert got.shape == want.shape == (1 + dst[0] * dst[1], 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if src == 14 and dst == (16, 8):  # the width shrinks: plain bilinear differs
        grid = torch.from_numpy(pos[1:].reshape(1, src, src, 12)).permute(0, 3, 1, 2)
        plain = torch.nn.functional.interpolate(grid, dst, mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).reshape(-1, 12).numpy() - want[1:]).max() > 1e-2
    with pytest.raises(ValueError, match="non-square"):
        tconvert._resize_clip_pos_embed(pos[:-1], *dst)


@pytest.fixture(scope="module")
def converted():
    sd = tiny_clip()
    return {naming: (jconvert.convert_clip(s), tconvert.convert_clip(s))
            for naming, s in (("openai", sd), ("clipreid", finetune_naming(sd)))}


@pytest.mark.parametrize("naming", ["openai", "clipreid"])
def test_convert_clip_equals_jax(converted, naming):
    """Both namings: the converted weights equal JAX's carried across, the
    image features (256 x 128 crops: the 16 x 8 grid) and the text tower's
    outputs equal JAX's."""
    jout, tout = converted[naming]
    vis = tclip.ClipReID(crop_hw=(256, 128), width=W, layers=LAYERS, heads=1, proj_dim=EMB).eval()
    want_sd = tconvert.backbone_state_dict_from_flax(jout["visual"], "clip", model=vis)
    assert tout["visual_config"] == {"width": W, "layers": LAYERS, "heads": 1, "proj_dim": EMB,
                                     "crop_hw": (256, 128)}
    assert tout["text_config"] == {"width": W, "layers": LAYERS, "heads": 1, "context": CTX,
                                   "proj_dim": EMB}
    for k, v in want_sd.items():
        np.testing.assert_allclose(tout["visual"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    vis.load_state_dict(tout["visual"])
    x = np.random.default_rng(3).uniform(-2, 2, (2, 256, 128, 3)).astype(np.float32)
    jvis = jclip.ClipReID(width=W, layers=LAYERS, heads=1, proj_dim=EMB)
    want = np.asarray(jax.jit(jvis.apply)(jout["visual"], jnp.asarray(x)))
    with torch.no_grad():
        got = vis(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    assert got.shape == want.shape == (2, W + EMB)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    text = tclip.ClipTextEncoder(**tout["text_config"]).eval()
    text.load_state_dict(tout["text"])
    prompts = np.random.default_rng(4).normal(0, 0.1, (3, 12, W)).astype(np.float32)
    eot = np.array([11, 7, 3])
    jtext = jclip.ClipTextEncoder(width=W, layers=LAYERS, heads=1, context=CTX, proj_dim=EMB)
    want = np.asarray(jtext.apply(jout["text"], jnp.asarray(prompts), jnp.asarray(eot)))
    with torch.no_grad():
        got = text(torch.from_numpy(prompts), torch.from_numpy(eot)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(tout["token_embedding"], jout["token_embedding"])
    assert tout["logit_scale"] == jout["logit_scale"]
    if naming == "clipreid":
        np.testing.assert_array_equal(tout["prompt_cls_ctx"], jout["prompt_cls_ctx"])
    else:
        assert tout["prompt_cls_ctx"] is None is jout["prompt_cls_ctx"]


def test_convert_checkpoint_and_unmapped_keys():
    sd = tiny_clip(2)
    visual = tconvert.convert_checkpoint(sd, "clip")
    assert all(torch.equal(v, tconvert.convert_clip(sd)["visual"][k]) for k, v in visual.items())
    for fn in (tconvert.convert_clip, jconvert.convert_clip):
        with pytest.raises(ValueError, match="unmapped CLIP checkpoint keys"):
            fn({**sd, "mystery.weight": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="only ViT CLIP"):
            fn({k: v for k, v in sd.items() if k != "visual.proj"})


def test_facade_serves_clip():
    """``ReID("clip")`` (seeded ViT-B/16 weights, the crop's 16 x 8 grid) gives
    1280-d unit rows; at 64 x 32 crops its grid is 4 x 2."""
    img = np.random.default_rng(3).integers(0, 256, (120, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 5, 60, 100], [100, 20, 150, 110]], np.float32)
    for hw, rows in (((256, 128), 129), ((64, 32), 9)):
        reid = ReID(model_name="clip", device="cpu", crop_hw=hw)
        assert reid.model.positional_embedding.shape == (rows, 768)
        f = reid.get_features(boxes, img)
        assert f.shape == (2, 1280) and np.isfinite(f).all()
        np.testing.assert_allclose(np.linalg.norm(f, axis=1), 1.0, atol=1e-5)


def test_clip_prompt_losses_equal_jax():
    rng = np.random.default_rng(5)
    img, txt = rng.normal(size=(2, 12, EMB)).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3, 0, 1, 4, 4])
    want = float(jclip.clip_prompt_losses(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(labels)))
    got = float(tclip.clip_prompt_losses(torch.from_numpy(img), torch.from_numpy(txt),
                                         torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


def test_prompt_template_equals_jax():
    emb = tiny_clip()["token_embedding.weight"]
    for got, want in zip(tclip.pretrained_prompt_template(emb),
                         jclip.pretrained_prompt_template(emb)):
        np.testing.assert_array_equal(got, want)


def _labels_and_feats(seed, n_ids=4, n=24):
    rng = np.random.default_rng(seed)
    labels = np.arange(n) % n_ids
    centers = rng.normal(size=(n_ids, EMB))
    return (centers[labels] + rng.normal(0, 0.5, (n, EMB))).astype(np.float32), labels


@pytest.mark.parametrize("mode", ["scratch", "pretrained"])
def test_learn_identity_prompts_equals_jax(converted, mode):
    """Five steps from the JAX stage's initial parameters: from scratch (the
    prompt trains, the text tower is frozen) and from the converted tiny CLIP
    (only the context vectors train)."""
    feats, labels = _labels_and_feats(6)
    cfg = jprompt.PromptStageConfig(num_classes=4, feat_dim=EMB, width=W, text_layers=LAYERS,
                                    text_heads=1, batch=16, steps=5, lr=1e-2, seed=3)
    tcfg = tprompt.PromptStageConfig(**dataclasses.asdict(cfg))
    if mode == "scratch":
        jstage = jprompt.PromptStage(cfg)
        pre = {}
    else:
        jout, tout = converted["openai"]
        prefix, suffix, _ = jclip.pretrained_prompt_template(jout["token_embedding"])
        jstage = jprompt.PromptStage(cfg, n_prefix=len(prefix), n_suffix=len(suffix),
                                     text_context=CTX)
        pre = {"pretrained": tout}
    init = jax.tree.map(np.asarray, jstage.init(jax.random.PRNGKey(cfg.seed)))
    _, jparams, jlosses = jprompt.learn_identity_prompts(
        feats, labels, cfg, pretrained=None if mode == "scratch" else converted["openai"][0])
    start = init if mode == "scratch" else {"prompt": init["prompt"]}
    stage, params, losses = tprompt.learn_identity_prompts(feats, labels, tcfg, params=start,
                                                           device="cpu", **pre)
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    for key in ("cls_ctx", "token_prefix", "token_suffix"):
        np.testing.assert_allclose(params["prompt"][key].numpy(),
                                   np.asarray(jparams["prompt"][key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    # the text tower stayed where it started
    want_text = tprompt.PromptStage(tcfg, *((5, 2, None) if mode == "scratch" else
                                            (len(prefix), len(suffix), CTX))).text
    want_text.load_state_dict(tout["text"] if mode == "pretrained" else
                              tconvert.state_dict_from_flax_paths(want_text, "clip",
                                                                  {"params": init["text"]}))
    assert all(torch.equal(params["text"][k], v) for k, v in want_text.state_dict().items())
    assert stage.prompt.cls_ctx.device == torch.device("cpu")
