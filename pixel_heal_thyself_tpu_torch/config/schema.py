"""Typed configuration dataclasses.

Mirrors reference `pht/config/base.py:11-223` and `pht/config/registry.py`,
with the documented holes fixed (SURVEY.md §2.1):

- model-level YAML keys (`input_channels`, `curve_order`, `losses`,
  `discriminator`, `use_film`, ...) actually bind instead of being dropped
  (reference `base.py:187-190` built the model config only from the
  `cfg.model.afgsa`/`cfg.model.mamba` subtree);
- `TrainerConfig` gains the `model_path` field that resume reads
  (reference `base_trainer.py:343` referenced a nonexistent field);
- new TPU-specific knobs: `TrainerConfig.precision`, `ParallelConfig`.

Copy of the JAX package's `pixel_heal_thyself_tpu/config/schema.py`, so that the
port imports nothing of that package; tests/test_torch_port_host.py
holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, ClassVar, List, Type, Union

from pixel_heal_thyself_tpu_torch.ops.curves import CurveOrder


@dataclass
class PathConfig:
    root: str = "."
    output_dir: str = "outputs"


@dataclass
class ImagesConfig:
    dir: str = "data/images"
    scale: float = 1.0
    # generate synthetic scenes when dir is missing (CI/tests; the
    # reference's bundled CI EXRs are not redistributable)
    synthesize: bool = False
    synthetic_size: int = 128
    # relative MC-noise coefficient of the synthetic renders: the noisy
    # channel's std is `synthetic_noise / sqrt(spp)` of the radiance.
    # 3.0 ≈ a very noisy 32spp channel (historic default); ~0.75 lands
    # denoised output in the reference tooling's 35–43 dB design band
    # (BASELINE.md round-4 quality-band validation)
    synthetic_noise: float = 3.0


@dataclass
class PatchesConfig:
    patch_size: int = 128
    num_patches: int = 400
    dir: str = ""


@dataclass
class DataConfig:
    images: ImagesConfig = field(default_factory=ImagesConfig)
    patches: PatchesConfig = field(default_factory=PatchesConfig)
    # input pipeline: "auto" picks "device" (whole patch store cached in
    # HBM, batches gathered on-device — data/dataset.py:DeviceLoader) when
    # single-process and the store fits device_cache_limit_gb, else
    # "native" (thread-prefetch h5 reader). "grain" is the Grain-backed
    # alternative (optional multi-process workers; single-host only).
    loader: str = "auto"
    # device budget for the device-resident store under loader=auto (the
    # value the JAX trainer chose for a 16 GB TPU v5e; the port has no
    # loader yet)
    device_cache_limit_gb: float = 6.0


@dataclass
class OptimizerConfig:
    name: str = "adam"
    lr: float = 1e-4
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    eps: float = 1e-8


@dataclass
class SchedulerConfig:
    name: str = "multistep"
    milestones: List[int] = field(default_factory=lambda: [3, 6, 9])
    gamma: float = 0.5


@dataclass
class LossesConfig:
    l1_loss_w: float = 1.0
    gan_loss_w: float = 0.005
    gp_loss_w: float = 10.0
    use_lpips_loss: bool = False
    lpips_loss_w: float = 0.1
    # converted VGG16+lin weights npz (tools/convert_lpips_weights.py);
    # the literal value "random" uses random weights (tests/ablation)
    lpips_weights_path: str = ""
    use_ssim_loss: bool = False
    ssim_loss_w: float = 0.1


@dataclass
class TrainerConfig:
    batch_size: int = 8
    epochs: int = 12
    deterministic: bool = True
    save_interval: int = 1
    num_saved_imgs: int = 6

    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    lr_g: float = 1e-4
    lr_d: float = 1e-4
    lr_gamma: float = 0.5
    lr_milestone: int = 3

    load_model: bool = False
    model_path: str = ""

    # TPU-native knobs (not in the reference)
    precision: str = "bf16"  # compute dtype for conv/attention: bf16 | fp32
    prefetch_batches: int = 2  # host→device prefetch depth
    num_workers: int = 4  # loader reader threads (reference used 7 procs)
    # validation forward batch (reference ran val at batch 1,
    # base_trainer.py:536-547; per-sample metrics are computed on host so
    # any batch yields identical values — batching amortizes the per-call
    # dispatch latency that dominates batch-1 val on TPU)
    val_batch_size: int = 8
    use_pallas: bool = True  # fused attention kernel (TPU backends only)
    # fold the q/k/v 1×1 projections into the fused attention op (AFGSA
    # only; measured perf-neutral on the prod bench — BASELINE.md
    # round-3 negative results — kept as a reachable opt-in variant)
    fold_qkv: bool = False
    profile_dir: str = ""  # write a jax.profiler trace of early steps here


@dataclass
class ParallelConfig:
    """Mesh/sharding controls — new, TPU-native (no reference analog;

    the reference is strictly single-GPU, SURVEY.md §2.10).
    """

    data_axis: int = -1  # -1: use all available devices for data parallelism
    model_axis: int = 1  # tensor-parallel degree (heads/channels)
    spatial_axis: int = 1  # spatial sharding for full-frame inference
    # join the process group of a launcher (`python -m torch.distributed.run`:
    # RANK/WORLD_SIZE, init_method env://), parallel/distributed.py
    multihost: bool = False


@dataclass
class SelfAttentionConfig:
    num_layers: int = 5
    block_size: int = 8
    halo_size: int = 3
    num_heads: int = 4


@dataclass
class DiscriminatorConfig:
    use_multiscale_discriminator: bool = False
    use_film: bool = False


@dataclass
class BaseModelConfig:
    name: str = "base"
    input_channels: int = 3
    aux_input_channels: int = 7
    feature_map_channels: int = 256
    # encoder per-scale channels (1×1/3×3/5×5 branches). Not separately
    # tunable in the reference (hardcoded 256, model.py:585-733); exposed
    # here so the non-parity fast profile can slim the whole trunk
    enc_channels: int = 256
    curve_order: CurveOrder = CurveOrder.RASTER
    use_film: bool = False
    num_gradient_checkpoints: int = 0
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    losses: LossesConfig = field(default_factory=LossesConfig)


@dataclass
class AFGSAModelConfig(BaseModelConfig):
    name: str = "afgsa"
    self_attention: SelfAttentionConfig = field(default_factory=SelfAttentionConfig)


@dataclass
class MambaModelConfig(BaseModelConfig):
    name: str = "mamba"
    num_layers: int = 5
    d_state: int = 64
    d_conv: int = 4
    expansion: int = 4
    headdim: int = 64


@dataclass
class LoggingConfig:
    level: str = "INFO"


def _build_dataclass(cls: type, data: dict[str, Any]) -> Any:
    """Recursively build a dataclass from a plain dict, ignoring unknowns
    that start with '_' and erroring on other unknown keys."""
    kwargs: dict[str, Any] = {}
    field_map = {f.name: f for f in fields(cls)}
    for k, v in data.items():
        if k.startswith("_"):
            continue
        if k not in field_map:
            raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = field_map[k].type
        target = _FIELD_CLASS_OVERRIDES.get((cls, k))
        if target is None and isinstance(ftype, type) and is_dataclass(ftype):
            target = ftype
        if target is not None and isinstance(v, dict):
            kwargs[k] = _build_dataclass(target, v)
        elif (cls, k) in _ENUM_FIELDS and isinstance(v, str):
            kwargs[k] = _ENUM_FIELDS[(cls, k)](v)
        elif ftype in ("float", float) and isinstance(v, (int, str)):
            kwargs[k] = float(v)
        elif ftype in ("int", int) and isinstance(v, str):
            kwargs[k] = int(v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


@dataclass
class Config:
    """Root typed config (reference `pht/config/base.py:160-223`)."""

    seed: int = 990819
    data_ratio: float = 0.95
    run_num: int = -1
    paths: PathConfig = field(default_factory=PathConfig)
    data: DataConfig = field(default_factory=DataConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    model: Union[AFGSAModelConfig, MambaModelConfig] = field(
        default_factory=AFGSAModelConfig,
    )
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    @classmethod
    def from_tree(cls, cfg: dict[str, Any]) -> "Config":
        """Build a typed Config from a composed+resolved config tree.

        Unlike reference `base.py:179-223`, the model-level keys in the YAML
        (losses, discriminator, curve_order, channel counts...) are merged
        with the per-model subtree (`model.afgsa` / `model.mamba`) so they
        actually take effect.
        """
        model_tree = dict(cfg.get("model", {}))
        model_name = model_tree.get("name", "afgsa")
        model_cls = ConfigRegistry.get_model_config_class(model_name)
        # per-model subtree merges over the shared model-level keys
        per_model = model_tree.pop(model_name, {}) or {}
        for other in ConfigRegistry.model_names():
            model_tree.pop(other, None)
        merged_model = {**model_tree, **per_model, "name": model_name}
        model_cfg = _build_dataclass(model_cls, merged_model)

        kwargs: dict[str, Any] = {"model": model_cfg}
        section_classes = {
            "paths": PathConfig,
            "data": DataConfig,
            "trainer": TrainerConfig,
            "parallel": ParallelConfig,
            "logging": LoggingConfig,
        }
        scalar_keys = ("seed", "data_ratio", "run_num")
        # reject unknown top-level keys loudly — nested typos already error
        # in _build_dataclass, and a silently-dropped section ("trainerr:")
        # would run the job on defaults
        known = set(section_classes) | set(scalar_keys) | {"model"}
        # "_"-prefixed keys are composer-internal (e.g. _base_pattern for
        # the run-dirs resolver) and never bind to dataclass fields
        unknown = [k for k in cfg if k not in known and not k.startswith("_")]
        if unknown:
            raise ValueError(
                f"unknown top-level config key(s) {unknown}; expected one "
                f"of {sorted(known)}",
            )
        for key, sub_cls in section_classes.items():
            if key in cfg:
                kwargs[key] = _build_dataclass(sub_cls, cfg[key])
        for key in scalar_keys:
            if key in cfg:
                kwargs[key] = cfg[key]
        return cls(**kwargs)


# nested-field class mappings that aren't expressible via plain annotations
_FIELD_CLASS_OVERRIDES: dict[tuple[type, str], type] = {
    (DataConfig, "images"): ImagesConfig,
    (DataConfig, "patches"): PatchesConfig,
    (TrainerConfig, "optim"): OptimizerConfig,
    (TrainerConfig, "scheduler"): SchedulerConfig,
    (BaseModelConfig, "discriminator"): DiscriminatorConfig,
    (BaseModelConfig, "losses"): LossesConfig,
    (AFGSAModelConfig, "discriminator"): DiscriminatorConfig,
    (AFGSAModelConfig, "losses"): LossesConfig,
    (AFGSAModelConfig, "self_attention"): SelfAttentionConfig,
    (MambaModelConfig, "discriminator"): DiscriminatorConfig,
    (MambaModelConfig, "losses"): LossesConfig,
}

_ENUM_FIELDS: dict[tuple[type, str], type] = {
    (BaseModelConfig, "curve_order"): CurveOrder,
    (AFGSAModelConfig, "curve_order"): CurveOrder,
    (MambaModelConfig, "curve_order"): CurveOrder,
}


class ConfigRegistry:
    """name → model-config-class registry (reference `registry.py:15-53`)."""

    _model_configs: ClassVar[dict[str, Type[BaseModelConfig]]] = {
        "afgsa": AFGSAModelConfig,
        "mamba": MambaModelConfig,
    }

    @classmethod
    def model_names(cls) -> list[str]:
        return list(cls._model_configs)

    @classmethod
    def get_model_config_class(cls, model_name: str) -> Type[BaseModelConfig]:
        if model_name not in cls._model_configs:
            raise ValueError(f"Unsupported model: {model_name}")
        return cls._model_configs[model_name]

    @classmethod
    def register_model_config(
        cls,
        name: str,
        config_class: Type[BaseModelConfig],
    ) -> None:
        cls._model_configs[name] = config_class

    @classmethod
    def create_config(cls, cfg_tree: dict[str, Any]) -> Config:
        return Config.from_tree(cfg_tree)

    @classmethod
    def validate_config(cls, config: Config) -> bool:
        model_class = cls.get_model_config_class(config.model.name)
        if not isinstance(config.model, model_class):
            raise TypeError(
                f"Expected model config of type {model_class.__name__}, "
                f"got {type(config.model).__name__}",
            )
        return True
