"""Unified configuration tree for the framework.

The PyTorch port's own copy of the JAX package's configuration dataclasses
(field for field, so a config serialized by either package loads in the
other). One frozen dataclass replaces the reference's two argparse dialects
(src/mdgen/parsing.py:5-125 and src/rtb_utils/args.py:25-194).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Denoiser architecture (reference defaults: src/mdgen/parsing.py:77-97)."""

    num_layers: int = 5
    embed_dim: int = 384
    mha_heads: int = 16
    ipa_heads: int = 4
    ipa_head_dim: int = 32
    ipa_qk: int = 8
    ipa_v: int = 8
    dropout: float = 0.0
    hyena: bool = False
    hyena_filter_order: int = 64
    no_rope: bool = False
    prepend_ipa: bool = False
    interleave_ipa: bool = False
    no_aa_emb: bool = False
    abs_pos_emb: bool = False
    abs_time_emb: bool = False
    time_multiplier: float = 100.0
    grad_checkpointing: bool = False
    # numerics: bf16 activations with f32 params/accumulation
    use_bf16: bool = True


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Flow-matching settings (src/mdgen/parsing.py:99-106)."""

    path_type: str = "GVP"  # Linear | GVP | VP
    prediction: str = "velocity"  # velocity | score | noise
    loss_weight: str = "none"  # none | velocity | likelihood (noise/score only)
    sampling_method: str = "dopri5"  # dopri5 | euler | heun
    inference_steps: int = 100  # fixed-step count for euler/heun
    alpha_max: float = 8.0
    discrete_loss_weight: float = 0.5
    dirichlet_flow_temp: float = 1.0
    allow_nan_cfactor: bool = False
    train_eps: float = 0.0
    sample_eps: float = 0.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset settings (src/mdgen/parsing.py:49-60)."""

    data_dir: str = ""
    train_split: str = ""
    val_split: str = ""
    num_frames: int = 50
    crop: int = 256
    suffix: str = ""
    atlas: bool = False
    frame_interval: Optional[int] = None
    overfit: bool = False
    overfit_peptide: Optional[str] = None
    overfit_frame: bool = False
    copy_frames: bool = False


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Conditioning-task selection (src/mdgen/parsing.py:110-120 'video settings')."""

    sim_condition: bool = False
    tps_condition: bool = False
    inpainting: bool = False
    design: bool = False
    dynamic_mpnn: bool = False
    mpnn: bool = False
    cond_interval: Optional[int] = None
    design_key_frames: bool = False
    no_torsion: bool = False
    no_design_torsion: bool = False
    supervise_all_torsions: bool = False
    supervise_no_torsions: bool = False
    no_offsets: bool = False
    no_frames: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / loop settings (src/mdgen/parsing.py:37-47)."""

    lr: float = 1e-4
    adamW: bool = False
    grad_clip: float = 1.0
    accumulate_grad: int = 1
    ema: bool = False
    ema_decay: float = 0.999
    epochs: int = 100
    batch_size: int = 8
    ckpt_freq: int = 1
    print_freq: int = 100
    seed: int = 137
    # parallelism: data-parallel and sequence(frame)-parallel mesh axes
    dp_size: int = 1
    sp_size: int = 1


@dataclasses.dataclass(frozen=True)
class MDGenConfig:
    model: ModelConfig = ModelConfig()
    transport: TransportConfig = TransportConfig()
    data: DataConfig = DataConfig()
    task: TaskConfig = TaskConfig()
    train: TrainConfig = TrainConfig()
    run_name: str = "default"
    workdir: str = "workdir"

    # ------------------------------------------------------------------
    @property
    def latent_dim(self) -> int:
        """Per-token latent width (src/mdgen/wrapper.py:195-202)."""
        t = self.task
        dim = 28 if (t.tps_condition or t.inpainting or t.dynamic_mpnn) else 21
        if t.design:
            dim += 20
        if t.no_frames:
            dim = 111
        return dim

    @property
    def doubled_offsets(self) -> bool:
        t = self.task
        return t.tps_condition or t.inpainting or t.dynamic_mpnn

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "MDGenConfig":
        d = json.loads(s)
        return MDGenConfig(
            model=ModelConfig(**d.get("model", {})),
            transport=TransportConfig(**d.get("transport", {})),
            data=DataConfig(**d.get("data", {})),
            task=TaskConfig(**d.get("task", {})),
            train=TrainConfig(**d.get("train", {})),
            run_name=d.get("run_name", "default"),
            workdir=d.get("workdir", "workdir"),
        )

    def replace(self, **kw) -> "MDGenConfig":
        return dataclasses.replace(self, **kw)


# Reference README task presets (README.md:50-98; see BASELINE.md)
def preset_4aa_sim(**overrides) -> MDGenConfig:
    cfg = MDGenConfig(
        model=ModelConfig(prepend_ipa=True, abs_pos_emb=True, abs_time_emb=False),
        data=DataConfig(num_frames=1000, crop=4, suffix="_i100"),
        task=TaskConfig(sim_condition=True),
    )
    return cfg.replace(**overrides) if overrides else cfg


def preset_4aa_tps(**overrides) -> MDGenConfig:
    cfg = MDGenConfig(
        model=ModelConfig(prepend_ipa=True, abs_pos_emb=True),
        data=DataConfig(num_frames=100, crop=4, suffix="_i100"),
        task=TaskConfig(tps_condition=True),
    )
    return cfg.replace(**overrides) if overrides else cfg


def preset_4aa_upsampling(**overrides) -> MDGenConfig:
    cfg = MDGenConfig(
        model=ModelConfig(prepend_ipa=True, abs_pos_emb=True),
        data=DataConfig(num_frames=1000, crop=4),
        task=TaskConfig(sim_condition=True, cond_interval=100),
    )
    return cfg.replace(**overrides) if overrides else cfg


def preset_4aa_design(**overrides) -> MDGenConfig:
    cfg = MDGenConfig(
        model=ModelConfig(prepend_ipa=True, abs_pos_emb=True, no_aa_emb=True),
        transport=TransportConfig(sampling_method="euler"),
        data=DataConfig(num_frames=100, crop=4, frame_interval=10),
        task=TaskConfig(inpainting=True, design=True, no_torsion=True),
    )
    return cfg.replace(**overrides) if overrides else cfg


def preset_atlas(**overrides) -> MDGenConfig:
    cfg = MDGenConfig(
        model=ModelConfig(prepend_ipa=True, abs_pos_emb=True),
        data=DataConfig(num_frames=250, crop=256, atlas=True, suffix="_i40"),
        task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=1),
    )
    return cfg.replace(**overrides) if overrides else cfg
