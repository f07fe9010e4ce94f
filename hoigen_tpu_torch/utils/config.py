"""Run configuration: a typed mirror of the reference's ~90 argparse flags
(reference/main_tip_finetune.py:1046-1194), including the four options
the reference hard-codes inside main() (dino / clip_global /
dino_load_cache / clip_load_cache, :393-396) and the cache_model /
generate_feature overrides (:444-445) — here they are real flags.

Port of ``hoigen_tpu/utils/config.py``, the same algorithm in the same order
(the tests hold the two packages equal).
"""
import argparse
import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass
class RunConfig:
    # optimization (defaults = train_hico.sh / argparse)
    lr_head: float = 1e-3
    lr_vit: float = 1e-3
    batch_size: int = 4
    weight_decay: float = 1e-4
    epochs: int = 20
    lr_drop: int = 10
    clip_max_norm: float = 0.1
    seed: int = 66

    # focal loss
    alpha: float = 0.5
    gamma: float = 0.2

    # dataset
    dataset: str = "hicodet"               # hicodet | vcoco
    partitions: List[str] = dataclasses.field(
        default_factory=lambda: ["train2015", "test2015"])
    data_root: str = "./datasets"
    num_workers: int = 2
    output_dir: str = "outputs/hico"
    print_interval: int = 500
    # host-side PIL 224 stream instead of the on-device derivation
    # (ops/resize); device is the default — the reference's IResize runs
    # after the DETR resize, so the derivation is semantics-preserving
    host_clip_stream: bool = False

    # modes
    eval: bool = False
    cache: bool = False
    sanity: bool = False
    resume: str = ""

    # detection / pairing
    human_idx: int = 0
    box_score_thresh: float = 0.2
    fg_iou_thresh: float = 0.5
    min_instances: int = 3
    max_instances: int = 15

    # checkpoints to convert
    pretrained_detr: str = "checkpoints/detr-r50-hicodet.pth"
    clip_model_path: str = "checkpoints/pretrained_clip/ViT-B-16.pt"
    dino_pretrained: str = "dino/dino_resnet50_pretrain.pth"

    # model
    num_classes: int = 117                 # 117 | 24 | 600
    logits_type: str = "HO+U+T"
    # gen_feat is the reference's effective default (hardcoded override at
    # main_tip_finetune.py:444); its cache_feat path cannot even construct
    # upstream (4-into-5 unpack at upt_tip...py:421,424) — ours can
    cache_model: str = "gen_feat"          # cache_feat | gen_feat
    num_shot: int = 2
    file1: str = ("./hicodet_pkl_files/"
                  "union_embeddings_cachemodel_crop_padding_zeros_vitb16.p")
    use_insadapter: bool = True
    adapter_pos: str = "all"
    adapter_num_layers: int = 1
    prior_type: str = "cbe"
    prior_method: int = 0          # 0 instance-wise | 1 pair-wise | 2 learnable
    vis_prompt_num: int = 50       # prior tokens when prior_method == 2
    # exposed for reference-flag parity; rejected with a clear error at model
    # build (the reference code paths are broken at the source; see
    # models/upt.py UPTConfig.__post_init__)
    use_consistloss: bool = False
    tpt: bool = False
    use_multi_hot: bool = True
    label_choice: str = "random"
    # train on a random fraction of the training set when < 0.9
    # (main_tip_finetune.py:368-372)
    training_set_ratio: float = 1.0
    # freeze cache-adapter branches, e.g. "HO+T" (main_tip...py:964-977)
    frozen_classifier: str = ""
    use_templates: bool = False
    LA: bool = False
    LA_weight: float = 0.6
    feat_mask_type: int = 0
    use_weight_pred: bool = False
    use_mlp_proj: bool = False
    obj_affordance: bool = False
    box_proj: int = 0
    hyper_lambda: float = 2.8
    vis_tor: float = 1.0
    dino: bool = True
    clip_global: bool = True
    dino_load_cache: bool = True
    clip_load_cache: bool = True
    generate_feature: bool = True
    gen_rounds: int = 100
    # 'pair_one_hots' = reference runtime (one_hots_U substituted for the
    # built global/dino values, upt_tip...py:432,442-450); 'built' = the
    # per-image multi-hots from the cache builders (utils.py:31-57)
    global_values_mode: str = "pair_one_hots"

    # zero-shot
    zs: bool = False
    zs_type: str = "rare_first"
    fill_zs_verb_type: int = 0

    # CoOp prompts (main classifier path)
    N_CTX: int = 24
    CSC: bool = False
    CTX_INIT: str = ""
    CLASS_TOKEN_POSITION: str = "end"

    # generator checkpoints dir (main_coop_vae/finetune_ship outputs)
    gen_ckpt_dir: str = "ckpt"

    # port-specific
    devices: Optional[int] = None          # data-parallel size (None = all)
    dtype: str = "float32"
    max_gt_pairs: int = 32
    # fused cache-scoring kernel (ops/pallas_cache.py, forward + VJP so it
    # serves train and eval). None = auto: on when running on CUDA
    use_pallas_cache: Optional[bool] = None
    # where the program's tracer writes program_trace.json and
    # program_trace_summary.json (engine/profiling.py); None: tracing off
    trace_dir: Optional[str] = None
    # the adapter-CLIP tower by OpenAI's name: "ViT-B/16" or
    # "ViT-L/14@336px" (models/clip/config.py::CLIP_MODELS); the
    # checkpoint at clip_model_path has to hold that model
    clip_model: str = "ViT-B/16"

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def add_args(parser: argparse.ArgumentParser,
             defaults: RunConfig = RunConfig()):
    for field in dataclasses.fields(RunConfig):
        name = "--" + field.name.replace("_", "-")
        default = getattr(defaults, field.name)
        if field.type == "bool" or isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, list):
            parser.add_argument(name, nargs="+", default=default)
        elif default is None:
            parser.add_argument(name, type=str if field.type == Optional[str]
                                else int, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)
    return parser


def parse_config(argv=None) -> RunConfig:
    parser = argparse.ArgumentParser(
        description="hoigen_tpu_torch: zero-shot HOI detection on PyTorch "
        "and CUDA")
    add_args(parser)
    args = parser.parse_args(argv)
    return RunConfig(**vars(args))
