"""The port's CLIP text path against the JAX package's, on the CPU: the BPE
tokenizer (token ids equal), the text tower (``encode_text``,
``text_encoder_forward``), the CLI's class-text encodes, and the prompted
generator's inference (``prompted_text_features``, one synthesis chunk
with z given, the synthesis driver's statistics). Weights are the JAX
package's random ones cast to float32 and handed over through the
bridge; both sides compute in float32, so the float outputs agree at the
transformer tolerance of the JAX package's full-dims suite, 2e-4.
"""
import sys
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from hoigen_tpu.cli import main_finetune as jcli
from hoigen_tpu.labels import HICO, VCOCO_LABELS
from hoigen_tpu.models import generator as jgen
from hoigen_tpu.models.clip import model as jclip
from hoigen_tpu.models.clip import tokenizer as jtok
from hoigen_tpu.models.clip.config import CLIPConfig as JCLIPConfig

from hoigen_tpu_torch.bridge import to_torch
from hoigen_tpu_torch.cli import main_finetune as tcli
from hoigen_tpu_torch.models import generator as tgen
from hoigen_tpu_torch.models.clip import model as tclip
from hoigen_tpu_torch.models.clip import tokenizer as ttok
from hoigen_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig

TOL = 2e-4
# a narrow text tower; the vocabulary is CLIP's, since the tokenizer's ids
# index it
TEXT = dict(transformer_layers=2, transformer_width=64, transformer_heads=4,
            context_length=77, vocab_size=49408)
# the generator's bias is 512 wide, so the synthesis needs a 512-wide text
# tower; one layer keeps it small
GEN_TEXT = dict(TEXT, transformer_layers=1, transformer_width=512,
                transformer_heads=8)
# the ViT fields only size the (unused) image tower
VIS = dict(image_resolution=32, vision_layers=1, vision_width=64,
           vision_patch_size=16, adapter_layers=(0,))


def _np32(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else np.asarray(a), tree)


def _clip(text_kw, key):
    """(JAX config, port config, JAX params as float32 numpy, the same as
    port tensors)."""
    jcfg = JCLIPConfig(**VIS, **text_kw)
    tcfg = TCLIPConfig(**VIS, **text_kw)
    params = _np32(jclip.init_clip_params(jax.random.PRNGKey(key), jcfg))
    return jcfg, tcfg, params, to_torch(params)


@pytest.fixture(scope="module")
def text_clip():
    return _clip(TEXT, 11)


@pytest.fixture(scope="module")
def gen_clip():
    return _clip(GEN_TEXT, 12)


# ---------------------------------------------------------------- tokenizer
def _cli_strings():
    """Every string the CLI tokenizes: the class texts of both datasets,
    their 8 template expansions, the object texts and the generator's
    prompts over its three class sets per dataset."""
    texts = list(HICO.hoi_prompts) + list(HICO.verbs_sentence) \
        + list(VCOCO_LABELS.verbs_sentence) \
        + [t for _, t in HICO.obj_text_label]
    for classes in (HICO.hoi_prompts, HICO.verbs_sentence,
                    VCOCO_LABELS.verbs_sentence):
        stripped = [" ".join(t.split(" ")[5:]) for t in classes]
        texts += [tmpl.format(s) for tmpl in jcli.PROMPT_TEMPLATES
                  for s in stripped]
    names = [HICO.all_classnames, HICO.human_name, HICO.object_name,
             [f"{v} {o}" for v, o in VCOCO_LABELS.values],
             VCOCO_LABELS.human_name, VCOCO_LABELS.object_name]
    for classnames in names:
        for n_ctx in (4, 5):
            texts += [" ".join(["X"] * n_ctx) + " " + n.replace("_", " ")
                      + "." for n in classnames]
    return texts


NON_ASCII = [
    "a person riding a vélo near the café", "naïve façade — über straße",
    "人が自転車に乗っている", "사람이 자전거를 탄다", "человек едет",
    "شخص يركب دراجة", "אדם רוכב", "ελληνικά ΣΊΣΥΦΟΣ ς",
    "x² + y³ = ½ Ⅻ ① ٣ ௰", "ͅ ̀a ᾳ ǅ ﬁ ß İ",
    "emoji 🚲🏄‍♀️ and ♥ ★", "tab\tnew\nnbsp\xa0thin ideo　",
    "sep\x1cfile\x1fend ​ zero-width ﻿ bom",
    "&amp;quot;html&amp;quot; &lt;tag&gt; it's we'll I'M",
    "ＦＵＬＬＷＩＤＴＨ ｔｅｘｔ １２３", "é vs é, ñ",
]


@pytest.mark.parametrize("strings", ["cli", "non_ascii"])
def test_tokenizer_matches_jax(strings):
    """Token ids equal the JAX tokenizer's on every string the CLI
    tokenizes and on a set of non-ASCII strings."""
    texts = _cli_strings() if strings == "cli" else NON_ASCII
    got = ttok.tokenize(texts, truncate=True)
    want = jtok.tokenize(texts, truncate=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(texts) > (5000 if strings == "cli" else 10)


def test_tokenizer_split_matches_regex_on_every_assigned_code_point():
    """The stdlib pattern splits as the ``regex`` one on every code point
    that the interpreter's Unicode tables assign: each char c is probed as
    'a' + c + c (a letter joins the run, a number stands alone, anything
    else forms a run of its own) and as "'" + c + 'x' (the contractions).
    Code points assigned only in a newer Unicode version than
    ``unicodedata``'s are the accepted mismatch (ROADMAP.md C)."""
    cps = [c for c in range(sys.maxunicode + 1)
           if not 0xD800 <= c <= 0xDFFF
           and unicodedata.category(chr(c)) != "Cn"]
    text = " ".join("a" + chr(c) * 2 + " '" + chr(c) + "x" for c in cps)
    split = ttok._patterns()[0]
    assert split.findall(text) == regex.findall(jtok._PATTERN, text)
    ws = "".join(chr(c) for c in cps)
    assert ttok._patterns()[1].findall(ws) == regex.findall(r"\s+", ws)


def test_tokenizer_round_trip_and_limits():
    tk = ttok._default_tokenizer()
    assert tk.decode(tk.encode("a photo of a person riding a bicycle.")) \
        == "a photo of a person riding a bicycle . "
    with pytest.raises(RuntimeError, match="too long"):
        ttok.tokenize("word " * 100)
    ids = ttok.tokenize("word " * 100, truncate=True)
    assert ids[0, -1] == tk.encoder["<|endoftext|>"]


# --------------------------------------------------------------- text tower
def test_encode_text_matches_jax(text_clip):
    jcfg, tcfg, params, tparams = text_clip
    toks = jtok.tokenize(list(HICO.verbs_sentence[:12]))
    want = jclip.encode_text(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(toks), jcfg)
    got = tclip.encode_text(tparams, torch.as_tensor(toks).long(), tcfg)
    assert got.shape == (12, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def test_text_encoder_forward_matches_jax(text_clip):
    """Arbitrary embeddings at arbitrary end positions (the prompt path)."""
    jcfg, tcfg, params, tparams = text_clip
    rng = np.random.default_rng(3)
    embeds = rng.normal(0, 0.05, (5, 77, 64)).astype(np.float32)
    eot = np.asarray([3, 76, 10, 0, 40])
    want = jclip.text_encoder_forward(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(embeds), jnp.asarray(eot),
                                      jcfg)
    got = tclip.text_encoder_forward(tparams, torch.as_tensor(embeds),
                                     torch.as_tensor(eot), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def test_port_text_init_has_the_jax_shapes_and_scales():
    """``init_clip_params(text=True)`` draws the JAX tree's text leaves, of
    its shapes and standard deviations (token 0.02, position 0.01)."""
    jcfg, tcfg = JCLIPConfig(**VIS, **TEXT), TCLIPConfig(**VIS, **TEXT)
    want = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)["text"]
    got = tclip.init_clip_params(torch.Generator().manual_seed(0), tcfg,
                                 text=True)["text"]
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [(p, a.shape) for p, a in jl] == [(p, a.shape) for p, a in tl]
    for p, a in tl:
        b = np.asarray(dict(jl)[p])
        assert abs(a.std() - b.std()) <= 0.05 * b.std() + 1e-12, p
    assert "text" not in tclip.init_clip_params(
        torch.Generator().manual_seed(0), tcfg)


@pytest.mark.parametrize("use_templates", [False, True])
def test_encode_class_texts_matches_jax(text_clip, use_templates):
    jcfg, tcfg, params, tparams = text_clip
    texts = list(HICO.verbs_sentence[:20])
    want = jcli.encode_class_texts(jax.tree.map(jnp.asarray, params), jcfg,
                                   texts, chunk=8,
                                   use_templates=use_templates)
    got = tcli.encode_class_texts(tparams, tcfg, texts, chunk=8,
                                  use_templates=use_templates)
    assert got.shape == (20, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ---------------------------------------------------------------- generator
@pytest.mark.parametrize("position", ["end", "middle", "front"])
def test_prompt_tables_and_prompted_features_match_jax(gen_clip, position):
    """The tables bit for bit, then the prompted text features of random
    context, bias and targets within 2e-4."""
    jcfg, tcfg, params, tparams = gen_clip
    emb = params["text"]["token_embedding"]
    names = list(HICO.object_name[:6])
    jt = jgen.build_prompt_tables(names, emb, 4,
                                  class_token_position=position)
    tt = tgen.build_prompt_tables(names, tparams["text"]["token_embedding"],
                                  4, class_token_position=position)
    for f in ("token_prefix", "token_suffix", "eot_idx", "template",
              "ctx_placement"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert (a is None) == (b is None) == (position == "end"
                                              and f in ("template",
                                                        "ctx_placement"))
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
    rng = np.random.default_rng(5)
    ctx = rng.normal(0, 0.02, (4, 512)).astype(np.float32)
    bias = rng.normal(0, 0.02, (7, 512)).astype(np.float32)
    target = rng.integers(0, 6, 7)
    want = jgen.prompted_text_features(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ctx), jt,
        jnp.asarray(bias), jnp.asarray(target))
    got = tgen.prompted_text_features(
        tparams, tcfg, torch.as_tensor(ctx), tt, torch.as_tensor(bias),
        torch.as_tensor(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * float(np.abs(want).max()))


def _families(params, rng_key, names, with_mlp):
    """JAX generator families over ``names`` ({family: classnames}) from
    random weights, and the same for the port."""
    emb = params["text"]["token_embedding"]
    jf, tf = {}, {}
    for i, (fam, classes) in enumerate(names.items()):
        k = jax.random.fold_in(jax.random.PRNGKey(rng_key), i)
        gp = _np32(jgen.init_generator_params(k))
        ctx = np.asarray(jgen.init_prompt_ctx(jax.random.fold_in(k, 1),
                                              5 if fam == "hoi" else 4),
                         np.float32)
        mlp = _np32(jgen.init_ship_mlp_params(jax.random.fold_in(k, 2))) \
            if with_mlp else None
        jf[fam] = jgen.GeneratorFamily(
            jax.tree.map(jnp.asarray, gp), jnp.asarray(ctx),
            jgen.build_prompt_tables(classes, emb, ctx.shape[0]),
            None if mlp is None else jax.tree.map(jnp.asarray, mlp))
        tf[fam] = tgen.GeneratorFamily(
            to_torch(gp), torch.as_tensor(ctx),
            tgen.build_prompt_tables(classes, torch.tensor(np.array(emb)),
                                     ctx.shape[0]),
            None if mlp is None else to_torch(mlp))
    return jf, tf


# a small synthesis class set: 8 HOI classes over 4 objects
HOI_TO_OBJ = np.asarray([0, 0, 1, 1, 2, 2, 3, 3])
HOI_TO_VERB = np.asarray([3, 5, 3, 7, 1, 5, 2, 9])
NAMES = {"hoi": [f"{v} {o}" for v, o in zip(
             ["riding", "holding", "eating", "cutting", "washing",
              "carrying", "throwing", "kicking"],
             ["bicycle", "bicycle", "pizza", "pizza", "cup", "cup",
              "ball", "ball"])],
         "human": ["person"] * 4,
         "object": ["bicycle", "pizza", "cup", "ball"]}


@pytest.mark.parametrize("with_mlp", [False, True])
def test_synthesis_chunk_with_given_z_matches_jax(gen_clip, with_mlp):
    """One chunk of the synthesis with z and the targets given, against
    the same computation in the JAX package (its jitted per-chunk
    function: generator, prompt, text tower, L2 norm, SHIP MLP)."""
    jcfg, tcfg, params, tparams = gen_clip
    jf, tf = _families(params, 7, NAMES, with_mlp)
    rng = np.random.default_rng(9)
    z = rng.normal(size=(10, 512)).astype(np.float32)
    for fam in NAMES:
        tgt = rng.integers(0, len(NAMES[fam]), 10)
        gf = jf[fam]
        bias = jgen.generator_forward(gf.gen_params, jnp.asarray(z))
        want = jgen.prompted_text_features(
            jax.tree.map(jnp.asarray, params), jcfg, gf.ctx, gf.tables, bias,
            jnp.asarray(tgt))
        want = want / jnp.linalg.norm(want, axis=-1, keepdims=True)
        if with_mlp:
            want = jgen.ship_mlp_forward(gf.mlp_params, want)
        got = tgen.synthesize_chunk(tparams, tcfg, tf[fam],
                                    torch.as_tensor(z), torch.as_tensor(tgt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * float(np.abs(want).max()))


def test_synthesize_features_shapes_targets_and_statistics(gen_clip):
    """The driver draws z from a torch.Generator, the JAX one from
    jax.random: the targets and verbs are equal, the features are unit
    vectors (no MLP) whose per-dimension means agree within 5 standard
    errors and whose per-dimension spreads agree within 25%, family by
    family. The same seed repeats the features; another changes them."""
    jcfg, tcfg, params, tparams = gen_clip
    jf, tf = _families(params, 8, NAMES, False)
    rounds = 40
    jfeat, jtgt, jverb = jgen.synthesize_features(
        jf, jax.tree.map(jnp.asarray, params), jcfg, HOI_TO_OBJ,
        HOI_TO_VERB, 8, n_rounds=rounds, rng=jax.random.PRNGKey(1),
        chunk=128)
    feat, tgt, verb = tgen.synthesize_features(
        tf, tparams, tcfg, HOI_TO_OBJ, HOI_TO_VERB, 8, n_rounds=rounds,
        seed=1, chunk=128)
    n = rounds * 8
    assert feat.shape == jfeat.shape == (3 * n, 512)
    assert feat.dtype == np.float32
    np.testing.assert_array_equal(tgt, jtgt)
    np.testing.assert_array_equal(verb, jverb)
    np.testing.assert_allclose(np.linalg.norm(feat, axis=-1), 1.0,
                               rtol=1e-5)
    jfeat = np.asarray(jfeat)
    for f in range(3):
        a, b = feat[f * n:(f + 1) * n], jfeat[f * n:(f + 1) * n]
        se = np.sqrt((a.var(0) + b.var(0)) / n)
        assert (np.abs(a.mean(0) - b.mean(0)) <= 5 * se + 1e-7).all(), f
        ratio = a.std(0) / b.std(0)
        assert ((ratio > 0.75) & (ratio < 1.33)).all(), (f, ratio.min(),
                                                          ratio.max())
        assert a.std(0).mean() > 1e-4          # z moves the features
    again, _, _ = tgen.synthesize_features(
        tf, tparams, tcfg, HOI_TO_OBJ, HOI_TO_VERB, 8, n_rounds=rounds,
        seed=1, chunk=64)
    other, _, _ = tgen.synthesize_features(
        tf, tparams, tcfg, HOI_TO_OBJ, HOI_TO_VERB, 8, n_rounds=rounds,
        seed=2, chunk=128)
    assert np.abs(again - feat).max() < 1e-5 and \
        np.abs(other - feat).max() > 1e-3


def test_generator_init_draws_the_jax_shapes_and_ranges():
    """The port's init_* functions: the JAX trees' shapes, uniform weights
    within +-1/sqrt(fan_in) (the torch Linear default), context N(0,
    0.02)."""
    g = torch.Generator().manual_seed(0)
    for jfn, tfn in ((jgen.init_generator_params, tgen.init_generator_params),
                     (jgen.init_encoder_params, tgen.init_encoder_params),
                     (jgen.init_ship_mlp_params, tgen.init_ship_mlp_params)):
        want = jfn(jax.random.PRNGKey(0))
        got = jax.tree.map(lambda t: t.numpy(), tfn(g))
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape
            bound = float(np.abs(np.asarray(b)).max())
            assert np.abs(a).max() <= bound * 1.01 and \
                np.abs(a).max() > 0.9 * bound
    ctx = tgen.init_prompt_ctx(g, 5)
    assert ctx.shape == (5, 512) and abs(float(ctx.std()) - 0.02) < 2e-3


def test_prompt_ctx_from_text_matches_jax(text_clip):
    """Context initialised from a phrase's token embeddings (--CTX_INIT):
    the same rows and count."""
    _, _, params, tparams = text_clip
    want, n_want = jgen.init_prompt_ctx_from_text(
        "a_photo of a", params["text"]["token_embedding"])
    got, n_got = tgen.init_prompt_ctx_from_text(
        "a_photo of a", tparams["text"]["token_embedding"])
    assert n_got == n_want == 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
