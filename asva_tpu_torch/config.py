"""Typed config system (dataclasses + YAML).  Port of asva_tpu/config.py.

Configs are plain frozen dataclasses with explicit loaders; the YAML files
under `configs/` (configs/audio-cond_animation/*.yaml, configs/avsync/*.yaml)
parse directly via `AnimationJobConfig.from_yaml` / `SyncJobConfig.from_yaml`
to the same field values as in asva_tpu — unknown keys are ignored with a
warning so config drift is visible but not fatal.  The UNet and schedule
fields are this package's own `UNet3DConfig` and `DiffusionSchedule`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import yaml

from .diffusion.schedules import DiffusionSchedule
from .models.unet3d.model import UNet3DConfig


def _take(d: dict, cls, _ignore=(), **renames):
    """Build dataclass `cls` from dict `d`, applying field renames and
    warning about unknown keys (`_ignore` lists keys that are known
    reference-only knobs we deliberately don't consume)."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        k = renames.get(k, k)
        if k not in fields:
            if k not in _ignore:
                warnings.warn(
                    f"config: unknown key {k!r} for {cls.__name__} ignored "
                    "(typo, or a reference knob this build doesn't consume)")
            continue
        # YAML 1.1 parses "2e-4" (no dot) as a string — coerce by field type
        ftype = fields[k].type
        if isinstance(v, str):
            if ftype in (float, "float"):
                v = float(v)
            elif ftype in (int, "int"):
                v = int(v)
        kwargs[k] = v
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    data_root: str = ""
    example_list_path: str = ""
    example_list_type: str = "video"
    mode: str = "train"
    img_size: Tuple[int, int] = (256, 256)
    randflip: bool = True
    video_fps: int = 6
    video_num_frame: int = 12
    class_mapping_json: Optional[str] = None
    class_text_encoding_mapping_pt: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    max_train_steps: int = 600_000
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    checkpointing_steps: int = 1000
    checkpointing_milestones: int = 0
    resume_from_checkpoint: str = "latest"
    mixed_precision: str = "bf16"   # fp16 in the reference; bf16 here
    enable_gradient_checkpoint: bool = False
    # full, highres, l0, saveconv, saveconv0 or dots: UNet3DConfig.remat_policy
    gradient_checkpoint_policy: str = "highres"


@dataclasses.dataclass(frozen=True)
class AnimationJobConfig:
    output_dir: str = "exps/run"
    seed: int = 123
    log_with: str = ""          # "wandb" mirrors metrics (exp.log_with)
    batch_size: int = 4
    log_steps: int = 10
    unet: UNet3DConfig = UNet3DConfig()
    schedule: DiffusionSchedule = DiffusionSchedule()
    n_segment: int = 12
    audio_cond_drop_prob: float = 0.2
    text_cond_drop_prob: float = 0.0
    loss_on_first_frame: bool = False
    dataset: DatasetConfig = DatasetConfig()
    optim: OptimConfig = OptimConfig()
    pretrained_unet_path: Optional[str] = None
    null_text_encoding_path: Optional[str] = None
    train_image_modules: bool = False  # unfreeze the grafted SD weights too
    trainable_modules: tuple = ("temp", "audio")

    @classmethod
    def from_yaml(cls, path: str) -> "AnimationJobConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        exp = raw.get("exp", {})
        model = raw.get("model", {})
        train = raw.get("train", {})
        optim_d = raw.get("optim", {})

        # _ignore: DDPMScheduler knobs at their no-op values in every
        # reference YAML (clip_sample/thresholding False, trained_betas
        # null); our DDIM/PLMS plans have no use for them
        sched = _take(model.get("scheduler", {}), DiffusionSchedule,
                      _ignore=("name", "trained_betas", "clip_sample",
                               "thresholding", "dynamic_thresholding_ratio",
                               "sample_max_value"))
        unet_d = dict(model.get("unet", {}))
        unet_kwargs = {}
        for key in ("down_block_types", "up_block_types", "mid_block_type",
                    "cross_attention_dim", "audio_cross_attention_dim",
                    "block_out_channels", "layers_per_block",
                    "norm_num_groups", "attention_head_dim"):
            if key in unet_d:
                v = unet_d[key]
                unet_kwargs[key] = tuple(v) if isinstance(v, list) else v
        unet_kwargs["remat"] = bool(optim_d.get("enable_gradient_checkpoint",
                                                False))
        unet_kwargs["remat_policy"] = optim_d.get(
            "gradient_checkpoint_policy", "highres")
        ds = _take(train.get("dataset", {}), DatasetConfig,
                   _ignore=("randcrop",))  # reference default False
        if isinstance(ds.img_size, list):
            object.__setattr__(ds, "img_size", tuple(ds.img_size))
        optim = _take(optim_d, OptimConfig,
                      _ignore=("use_8bit_adam", "scale_lr"))  # both off in
        #             every reference YAML; no 8-bit Adam / lr scaling here

        return cls(
            output_dir=exp.get("output_dir", "exps/run"),
            seed=exp.get("seed", 123),
            log_with=exp.get("log_with", "") or "",
            batch_size=train.get("batch_size", 4),
            log_steps=train.get("log_steps", 10),
            unet=UNet3DConfig(**unet_kwargs),
            schedule=sched,
            n_segment=model.get("audio_encoder", {}).get("n_segment", 12),
            audio_cond_drop_prob=model.get("audio_cond_drop_prob", 0.2),
            text_cond_drop_prob=model.get("text_cond_drop_prob", 0.0),
            loss_on_first_frame=model.get("loss_on_first_frame", False),
            dataset=ds,
            optim=optim,
            pretrained_unet_path=unet_d.get("pretrained_model_name_or_path"),
            train_image_modules=unet_d.get("train_image_modules", False),
            trainable_modules=tuple(
                m.strip("_") for m in unet_d.get("trainable_modules",
                                                 ["_temp", "_audio"])),
        )


@dataclasses.dataclass(frozen=True)
class SyncDatasetConfig:
    data_root: str = ""
    example_list_path: str = ""
    mode: str = "train"
    image_size: int = 224
    video_fps: int = 6
    video_num_frames: int = 12
    randflip: bool = True
    shift_time: float = 0.2
    num_clips: int = 21
    sampling_type: str = "random-compact"


@dataclasses.dataclass(frozen=True)
class SyncJobConfig:
    output_dir: str = "exps/avsync"
    seed: int = 123
    batch_size: int = 4
    log_steps: int = 10
    tau: float = 0.1
    # AVID-CMA initialization per encoder (reference model.*.pretrained
    # flags; avsync/models/audio.py:63-71 hard-codes the checkpoint path)
    audio_pretrained: bool = False
    video_pretrained: bool = False
    avid_cma_path: str = ("pretrained/AVID-CMA_Audioset_InstX-N1024-PosW-"
                          "N64-Top32_checkpoint.pth.tar")
    train_dataset: SyncDatasetConfig = SyncDatasetConfig()
    test_dataset: SyncDatasetConfig = SyncDatasetConfig(mode="test")
    test_batch_size: int = 8
    test_steps: int = 2500
    optim: OptimConfig = OptimConfig(max_train_steps=350_000,
                                     learning_rate=2e-4)

    @classmethod
    def from_yaml(cls, path: str) -> "SyncJobConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        exp = raw.get("exp", {})
        model = raw.get("model", {})
        train = raw.get("train", {})
        test = raw.get("test", {})

        def fix(dcfg):
            # audio_sample_rate: the 16 kHz pipeline constant
            # (CLIP_SAMPLE_RATE); every reference YAML sets 16000
            return _take(dcfg, SyncDatasetConfig,
                         _ignore=("audio_sample_rate",))

        return cls(
            output_dir=exp.get("output_dir", "exps/avsync"),
            seed=exp.get("seed", 123),
            batch_size=train.get("batch_size", 4),
            log_steps=train.get("log_steps", 10),
            tau=model.get("tau", 0.1),
            audio_pretrained=bool(
                model.get("audio_encoder", {}).get("pretrained", False)),
            video_pretrained=bool(
                model.get("video_encoder", {}).get("pretrained", False)),
            avid_cma_path=model.get(
                "avid_cma_path", SyncJobConfig.avid_cma_path),
            train_dataset=fix(train.get("dataset", {})),
            test_dataset=fix(test.get("dataset", {})),
            test_batch_size=test.get("batch_size", 8),
            test_steps=test.get("test_steps", 2500),
            # start from the SYNC defaults (350k steps, lr 2e-4) so a
            # missing/partial optim block doesn't fall back to the
            # animation defaults (600k, 1e-4)
            optim=_take({**dataclasses.asdict(
                             cls.__dataclass_fields__["optim"].default),
                         **raw.get("optim", {})}, OptimConfig,
                        _ignore=("use_8bit_adam", "scale_lr")),
        )
