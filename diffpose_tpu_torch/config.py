"""Typed configuration with YAML loading and CLI-override semantics.

Mirrors the reference's YAML schema (``configs/*.yml``) and its
``dict2namespace`` + "CLI wins for batch_size / lr / lr_gamma / decay"
rules (``main_diffpose_frame.py:88-91, 163-171``), but with dataclass
validation instead of free-form namespaces.

Counterpart of ``diffpose_tpu/config.py`` (this package keeps its own copy).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import yaml


@dataclass
class DataConfig:
    dataset: str = "human36m"
    dataset_path: str = "./data/data_3d_h36m.npz"
    dataset_path_train_2d: str = "./data/data_2d_h36m_gt_gmm.npz"
    dataset_path_test_2d: str = "./data/data_2d_h36m_gt_gmm.npz"
    num_joints: int = 17
    num_workers: int = 32  # kept for config parity; the loader needs none


@dataclass
class ModelConfig:
    hid_dim: int = 96
    emd_dim: int = 96  # reference overrides to 4*hid_dim inside the model
    coords_dim: Tuple[int, int] = (5, 5)
    num_layer: int = 5
    n_head: int = 4
    dropout: float = 0.25
    n_pts: int = 17
    ema_rate: float = 0.999
    ema: bool = True
    resamp_with_conv: bool = True
    var_type: str = "fixedsmall"


@dataclass
class DiffusionConfig:
    beta_schedule: str = "linear"
    beta_start: float = 1e-4
    beta_end: float = 1e-3
    num_diffusion_timesteps: int = 51


@dataclass
class TrainingConfig:
    batch_size: int = 1024
    n_epochs: int = 80
    num_workers: int = 32
    n_iters: Optional[int] = None
    snapshot_freq: Optional[int] = None
    validation_freq: Optional[int] = None


@dataclass
class TestingConfig:
    test_times: int = 1
    test_timesteps: int = 2
    test_num_diffusion_timesteps: int = 24
    track_time: bool = False
    track_memory: bool = False


@dataclass
class OptimConfig:
    decay: int = 60
    optimizer: str = "Adam"
    lr: float = 2e-5
    lr_gamma: float = 0.9
    eps: float = 1e-8
    amsgrad: bool = False
    grad_clip: float = 1.0


@dataclass
class ImplicitConfig:
    """Fixed-point solver settings (reference ``configs/human36m_ipose.yml:23-45``)."""

    solver: str = "anderson"
    max_iterations: int = 20
    tolerance: float = 0.1
    anderson_m: int = 5
    anderson_beta: float = 1.0
    anderson_lambda: float = 0.1
    min_iterations: int = 10
    use_warm_start: bool = False
    warm_start_momentum: float = 0.9
    # Adaptive knobs.  The REFERENCE declares these in
    # configs/human36m_ipose.yml:34-41 but never reads them anywhere (verified
    # by grep) — here they are IMPLEMENTED (beyond-reference):
    # use_adaptive_alpha → residual-monitored relaxation in the damped solver
    # (models/igcn.py:_solve_damped); use_progressive_tol → linear tolerance
    # annealing over global steps in the train step
    # (train/implicit_steps.py:make_implicit_train_step).
    use_adaptive_alpha: bool = False
    init_alpha: float = 0.5
    min_alpha: float = 0.1
    max_alpha: float = 0.9
    use_progressive_tol: bool = False
    init_tol: float = 0.1
    final_tol: float = 0.05
    tol_decay_steps: int = 1000


@dataclass
class VideoConfig:
    """Spatio-temporal (video) variant: window geometry + model depth.

    The reference delegates its video models to an external repo
    (``README.md:92-93``, 81/243-frame windows); here they are first-class
    (SURVEY §7.9).  Strides default to non-overlapping windows.
    """

    frames: int = 81
    train_stride: Optional[int] = None   # None → frames (non-overlapping)
    eval_stride: Optional[int] = None    # None → frames
    num_layers: int = 4
    dropout: float = 0.1
    # query-chunked temporal attention engages at/above this many frames
    # (beyond-VMEM windows); 0 disables
    attention_chunk: int = 256


@dataclass
class MixSTEConfig:
    """The video family's MixSTE denoiser (``models/mixste.py``), which takes
    the place of ``SpatioTemporalDiff`` where the section is present.  The
    defaults are MixSTE's published widths (arXiv 2203.00859;
    ``common/model_cross.py:MixSTE2`` run as ``-cs 512 -dep 8``): embedding
    512, 8 spatial and 8 temporal blocks, 8 heads, MLP ratio 2, a biased
    ``qkv``, LayerNorm eps 1e-6; no dropout at eval."""

    embed_dim: int = 512
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    dropout: float = 0.0


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    testing: TestingConfig = field(default_factory=TestingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    implicit: Optional[ImplicitConfig] = None
    video: Optional[VideoConfig] = None
    mixste: Optional[MixSTEConfig] = None


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "diffusion": DiffusionConfig,
    "training": TrainingConfig,
    "testing": TestingConfig,
    "optim": OptimConfig,
    "implicit": ImplicitConfig,
    "video": VideoConfig,
    "mixste": MixSTEConfig,
}


def _build_section(cls, values: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - known
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    if "coords_dim" in values and values["coords_dim"] is not None:
        values = dict(values)
        values["coords_dim"] = tuple(values["coords_dim"])
    return cls(**values)


def config_from_dict(raw: dict) -> Config:
    kwargs = {}
    for section, values in raw.items():
        if section not in _SECTIONS:
            raise ValueError(f"unknown config section: {section}")
        kwargs[section] = _build_section(_SECTIONS[section], dict(values))
    return Config(**kwargs)


def load_config(path: str, cli_overrides: Optional[dict] = None) -> Config:
    """Load a YAML config; apply the reference's 4 CLI-wins overrides.

    ``cli_overrides`` may contain ``batch_size``, ``lr``, ``lr_gamma``,
    ``decay`` (the flags the reference always copies over the YAML,
    ``main_diffpose_frame.py:88-91``) — pass only the ones explicitly set.
    """
    with open(path) as f:
        raw = yaml.safe_load(f)
    cfg = config_from_dict(raw)
    if cli_overrides:
        allowed = {"batch_size", "lr", "lr_gamma", "decay"}
        unknown = set(cli_overrides) - allowed
        if unknown:
            raise ValueError(f"unsupported CLI overrides: {sorted(unknown)}")
        if "batch_size" in cli_overrides:
            cfg.training.batch_size = int(cli_overrides["batch_size"])
        if "lr" in cli_overrides:
            cfg.optim.lr = float(cli_overrides["lr"])
        if "lr_gamma" in cli_overrides:
            cfg.optim.lr_gamma = float(cli_overrides["lr_gamma"])
        if "decay" in cli_overrides:
            cfg.optim.decay = int(cli_overrides["decay"])
    return cfg


def config_to_dict(cfg: Config) -> dict:
    out = dataclasses.asdict(cfg)
    for optional in ("implicit", "video", "mixste"):
        if out.get(optional) is None:
            out.pop(optional, None)
    return out


def save_config(cfg: Config, path: str):
    with open(path, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, default_flow_style=False)
