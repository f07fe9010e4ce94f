"""The CoOp-prompted feature generator (port of
``hoigen_tpu/models/generator.py``): the VAE encoder, generator and SHIP
MLP forwards, the VAE and SHIP training objectives, the conditional prompt
learner, batched unseen-class feature synthesis, their random init and the
converters of the reference's per-module ``.pth`` files.

Per family (hoi / human / object) a generator maps z ~ N(0, I) to a bias
that shifts the learned context tokens of a class prompt; the frozen CLIP
text tower encodes the prompt, and an optional SHIP MLP maps the
normalised feature onto the cached crop features. :func:`vae_step` and
:func:`ship_step` are the training objectives of ``cli/main_vae.py`` and
``cli/finetune_ship.py``; they take their normal draws as tensors.

:func:`synthesize_chunk` is one chunk of the synthesis with z and the
targets given; :func:`synthesize_features` draws z from a
``torch.Generator`` (the JAX package draws from ``jax.random``, so the two
agree on the chunk for the same z, and on the synthesis in distribution).
"""
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .clip.config import CLIPConfig
from .clip.model import text_encoder_forward
from .clip.tokenizer import tokenize

# D, the features' width, by default: ViT-B/16's embedding, which is also
# its text tower's width (main_finetune hands the generator's and the
# context's inits its tower's widths; main_vae and finetune_ship keep 512)
FEAT = 512


# ------------------------------------------------------------------ modules
def _linear_init(gen, out_d, in_d):
    bound = 1.0 / np.sqrt(in_d)
    return {"w": torch.rand((out_d, in_d), generator=gen) * 2 * bound - bound,
            "b": torch.rand((out_d,), generator=gen) * 2 * bound - bound}


def init_encoder_params(gen):
    return {"net": _linear_init(gen, 2048, FEAT),
            "mean": _linear_init(gen, FEAT, 2048),
            "log_var": _linear_init(gen, FEAT, 2048)}


def encoder_forward(p, x):
    """The VAE encoder: x (B, 512) -> (mean, log_var), each (B, 512)."""
    h = torch.relu(x @ p["net"]["w"].T + p["net"]["b"])
    return (h @ p["mean"]["w"].T + p["mean"]["b"],
            h @ p["log_var"]["w"].T + p["log_var"]["b"])


def init_generator_params(gen, dim: int = FEAT):
    """z (B, dim) -> a bias (B, dim) on the prompt's context tokens: dim
    is the CLIP embedding's width, which has to be the text tower's."""
    return {"l1": _linear_init(gen, 4096, dim),
            "l2": _linear_init(gen, dim, 4096)}


def generator_forward(p, z):
    h = torch.relu(z @ p["l1"]["w"].T + p["l1"]["b"])
    return h @ p["l2"]["w"].T + p["l2"]["b"]


def init_ship_mlp_params(gen):
    return [_linear_init(gen, FEAT, FEAT) for _ in range(3)]


def ship_mlp_forward(p, x):
    for i, lp in enumerate(p):
        x = x @ lp["w"].T + lp["b"]
        if i < len(p) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------- conditional prompt learner
@dataclasses.dataclass
class PromptTables:
    """Per-classname-set constants (numpy): SOS prefix, class + EOS suffix
    and the EOT position of each tokenized prompt. For the 'middle' and
    'front' class-token positions, a per-class ``template`` (L, D) holds
    every non-context token at its final position and ``ctx_placement``
    (L, n_ctx) places the context: prompts = template + placement @ ctx."""
    token_prefix: np.ndarray      # (C, 1, D)
    token_suffix: np.ndarray      # (C, 77-1-n_ctx, D)
    eot_idx: np.ndarray           # (C,)
    n_ctx: int
    template: Optional[np.ndarray] = None       # (C, L, D)
    ctx_placement: Optional[np.ndarray] = None  # (C, L, n_ctx)


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def init_prompt_ctx(gen, n_ctx: int, dim: int = FEAT):
    """Learned context tokens, N(0, 0.02) (main_coop_vae.py:86-88)."""
    return torch.randn((n_ctx, dim), generator=gen) * 0.02


def init_prompt_ctx_from_text(ctx_init: str, token_embedding):
    """Context vectors initialised from the words of ``ctx_init``
    (--CTX_INIT). Returns (ctx (n_ctx, D), n_ctx): n_ctx is the token count
    of the phrase."""
    ctx_init = ctx_init.replace("_", " ").strip()
    toks = tokenize([ctx_init])
    n_ctx = int(toks[0].argmax()) - 1            # tokens between SOS and EOT
    emb = _np(token_embedding)[toks[0, 1:1 + n_ctx]]
    return torch.as_tensor(emb), n_ctx


def build_prompt_tables(classnames: Sequence[str], token_embedding,
                        n_ctx: int, context_length: int = 77,
                        class_token_position: str = "end") -> PromptTables:
    prefix = " ".join(["X"] * n_ctx)
    prompts = [prefix + " " + name.replace("_", " ") + "." for name in
               classnames]
    toks = tokenize(prompts, context_length)
    emb = _np(token_embedding)[toks]
    tables = PromptTables(token_prefix=emb[:, :1],
                          token_suffix=emb[:, 1 + n_ctx:],
                          eot_idx=toks.argmax(-1), n_ctx=n_ctx)
    if class_token_position == "end":
        return tables
    if class_token_position not in ("middle", "front"):
        raise ValueError(class_token_position)
    # tokens are [SOS, name..., '.', EOT]: the name's length is the EOT
    # position less 2
    name_toks = tokenize([n.replace("_", " ") + "." for n in classnames],
                         context_length)
    name_lens = name_toks.argmax(-1) - 2
    c, length, d = emb.shape
    template = np.zeros((c, length, d), emb.dtype)
    placement = np.zeros((c, length, n_ctx), emb.dtype)
    half = n_ctx // 2
    for i in range(c):
        nl = int(name_lens[i])
        name_rows = emb[i, 1 + n_ctx:1 + n_ctx + nl]
        rest = emb[i, 1 + n_ctx + nl:]           # '.', EOT, padding
        template[i, 0] = emb[i, 0]               # SOS
        if class_token_position == "middle":
            # [SOS][ctx:half][name][ctx half:][rest]
            placement[i, np.arange(1, 1 + half), np.arange(half)] = 1
            template[i, 1 + half:1 + half + nl] = name_rows
            placement[i, np.arange(1 + half + nl, 1 + nl + n_ctx),
                      np.arange(half, n_ctx)] = 1
        else:                                    # front: [SOS][name][ctx]
            template[i, 1:1 + nl] = name_rows
            placement[i, np.arange(1 + nl, 1 + nl + n_ctx),
                      np.arange(n_ctx)] = 1
        template[i, 1 + n_ctx + nl:] = rest
    tables.template = template
    tables.ctx_placement = placement
    return tables


def tables_on(tables: PromptTables, device) -> PromptTables:
    """The tables with their arrays as tensors on ``device``, so that the
    prompt forwards of a loop copy nothing to the device."""
    return dataclasses.replace(tables, **{
        k: torch.as_tensor(v, device=device)
        for k, v in vars(tables).items() if isinstance(v, np.ndarray)})


def prompt_forward(ctx, tables: PromptTables, bias, target):
    """prompts = prefix[target] ++ (ctx + bias) ++ suffix[target]
    (main_coop_vae.py:117-128). bias: (B, D); target: (B,) class ids (a
    tensor on ctx's device). The 'middle' and 'front' positions use the
    template and placement."""
    dev = ctx.device
    shifted = ctx[None] + bias[:, None, :]
    if tables.template is not None:
        tpl = torch.as_tensor(tables.template, device=dev)[target]
        place = torch.as_tensor(tables.ctx_placement, device=dev)[target]
        return tpl + torch.einsum("blk,bkd->bld", place, shifted)
    prefix = torch.as_tensor(tables.token_prefix, device=dev)[target]
    suffix = torch.as_tensor(tables.token_suffix, device=dev)[target]
    return torch.cat([prefix, shifted, suffix], dim=1)


def prompted_text_features(clip_params, clip_cfg: CLIPConfig, ctx,
                           tables: PromptTables, bias, target):
    prompts = prompt_forward(ctx, tables, bias, target)
    eot = torch.as_tensor(tables.eot_idx, device=ctx.device)[target]
    return text_encoder_forward(clip_params, prompts, eot, clip_cfg)


# ------------------------------------- training (main_coop_vae.py:300-491)
def vae_loss(recon, x, mean, log_var):
    rec = torch.sum((recon - x) ** 2, dim=1).mean()
    kld = -0.5 * torch.sum(1 + log_var - mean ** 2 - torch.exp(log_var),
                           dim=1).mean()
    return rec + kld


def vae_step(params, tables, clip_params, clip_cfg, image_features, target,
             noise):
    """params: {enc, gen, ctx}; image_features (B, 512) L2-normalised;
    noise (B, 512) standard normal, the reparameterisation's draw (the JAX
    package draws it from a key inside the step). -> the scalar loss,
    differentiable in params."""
    mean, log_var = encoder_forward(params["enc"], image_features)
    z = torch.exp(0.5 * log_var) * noise + mean
    bias = generator_forward(params["gen"], z)
    text = prompted_text_features(clip_params, clip_cfg, params["ctx"],
                                  tables, bias, target)
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    return vae_loss(text, image_features, mean, log_var)


def ship_step(mlp_params, gen_params, ctx, tables, clip_params, clip_cfg,
              gt_features, target, z):
    """SHIP alignment (finetune_ship.py:474-530): z (B, 512) ~ N(0, I)
    through the frozen generator and prompts, the text tower and the
    trainable MLP, against the GT crop features. -> the scalar MSE."""
    bias = generator_forward(gen_params, z)
    text = prompted_text_features(clip_params, clip_cfg, ctx, tables, bias,
                                  target)
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    out = ship_mlp_forward(mlp_params, text)
    return torch.mean(torch.sum((out - gt_features) ** 2, dim=1))


# ------------------------------------------ batched unseen-feature synthesis
@dataclasses.dataclass
class GeneratorFamily:
    gen_params: dict            # frozen netG
    ctx: torch.Tensor           # frozen learned context
    tables: PromptTables        # built over the synthesis class set
    mlp_params: Optional[list]  # SHIP MLP (None -> identity)


def synthesize_chunk(clip_params, clip_cfg: CLIPConfig,
                     family: GeneratorFamily, z, targets):
    """One chunk of the synthesis: z (n, D) through the family's
    generator into the prompt of each target class (n,), the text tower,
    L2 normalisation and the SHIP MLP where there is one. -> (n, D)."""
    bias = generator_forward(family.gen_params, z)
    text = prompted_text_features(clip_params, clip_cfg, family.ctx,
                                  family.tables, bias, targets)
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    if family.mlp_params is not None:
        text = ship_mlp_forward(family.mlp_params, text)
    return text


@torch.no_grad()
def synthesize_features(families: dict, clip_params, clip_cfg: CLIPConfig,
                        hoi_to_obj: np.ndarray, hoi_to_verb: np.ndarray,
                        num_hoi: int, n_rounds: int = 100, seed: int = 0,
                        chunk: int = 2048):
    """families: {'hoi', 'human', 'object'} -> GeneratorFamily, on the
    device of ``clip_params``. Each round gives every HOI class one sample
    per family; the human and object families are conditioned on the HOI's
    object class (as the reference conditions both on the object id,
    main_tip_finetune.py:763-772). z is drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and the family's index.

    Returns numpy (gen_feature (3*N, D) stacked [hoi; human; object],
    gen_target (3*N,) HOI ids, gen_verb (N,) verb ids), N = n_rounds *
    num_hoi."""
    n = n_rounds * num_hoi
    hoi_ids = np.tile(np.arange(num_hoi), n_rounds)
    obj_ids = np.asarray(hoi_to_obj)[hoi_ids]
    targets = {"hoi": hoi_ids, "human": obj_ids, "object": obj_ids}
    dev = clip_params["text"]["token_embedding"].device

    out = {}
    for fi, (fam, gf) in enumerate(families.items()):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + fi)
        tgt_all = torch.as_tensor(targets[fam], device=dev)
        # the tables on the device once, not once a chunk
        gf = dataclasses.replace(gf, tables=tables_on(gf.tables, dev))
        width = gf.gen_params["l1"]["w"].shape[1]       # z's
        feats = []
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            z = torch.randn((hi - lo, width), generator=gen).to(dev)
            feats.append(synthesize_chunk(clip_params, clip_cfg, gf, z,
                                          tgt_all[lo:hi]).cpu())
        out[fam] = torch.cat(feats, 0).numpy()

    gen_feature = np.concatenate([out["hoi"], out["human"], out["object"]],
                                 axis=0).astype(np.float32)
    gen_target = np.concatenate([hoi_ids, hoi_ids, hoi_ids]).astype(np.int32)
    gen_verb = np.asarray(hoi_to_verb)[hoi_ids].astype(np.int32)
    return gen_feature, gen_target, gen_verb


# -------------------------------------------------- checkpoint converters
# the reference saves per-module .pth files (main_coop_vae.py:492-506,
# finetune_ship.py:532-538)
def _t(t):
    return t.detach().cpu().float() if isinstance(t, torch.Tensor) \
        else torch.as_tensor(np.asarray(t, np.float32))


def torch_encoder_state_to_params(sd):
    return {"net": {"w": _t(sd["net.0.weight"]), "b": _t(sd["net.0.bias"])},
            "mean": {"w": _t(sd["mean.weight"]), "b": _t(sd["mean.bias"])},
            "log_var": {"w": _t(sd["log_var.weight"]),
                        "b": _t(sd["log_var.bias"])}}


def torch_generator_state_to_params(sd):
    return {"l1": {"w": _t(sd["net.0.weight"]), "b": _t(sd["net.0.bias"])},
            "l2": {"w": _t(sd["net.2.weight"]), "b": _t(sd["net.2.bias"])}}


def torch_prompt_ctx_to_params(sd):
    return _t(sd["ctx"])


def torch_ship_mlp_state_to_params(sd):
    return [{"w": _t(sd[f"net.{i}.weight"]), "b": _t(sd[f"net.{i}.bias"])}
            for i in (0, 2, 4)]
