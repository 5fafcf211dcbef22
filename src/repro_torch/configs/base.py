"""Model configs of the port: the reference's ``repro/configs/base.py``.

Every assigned architecture has a module ``repro_torch/configs/<id>.py``
exporting ``CONFIG`` (the exact published shape) built on
:class:`ModelConfig`, field for field the reference's.
``ModelConfig.reduced()`` returns the CPU-sized variant of the same
family (<=2 layers, d_model<=512, <=4 experts).

The port serves and trains the dense family (``models/decode.py``,
``models/transformer.py``); the other families' configs are here so
the registry is whole. :data:`INPUT_SHAPES` are the dry run's input
shapes, :class:`TrainConfig` the training step's hyperparameters.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"   # Mamba2 + shared attention (zamba2)
SSM = "ssm"         # xLSTM (sLSTM + mLSTM)
VLM = "vlm"         # vision frontend stub + LM backbone
AUDIO = "audio"     # conv/mel frontend stub + enc-dec transformer

FAMILIES = (DENSE, MOE, HYBRID, SSM, VLM, AUDIO)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shape-complete description of one architecture (structure only)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # --- attention details -------------------------------------------------
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False                  # qwen1.5 style
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None    # SWA width (mixtral, gemma3 local)
    local_global_pattern: int = 0           # gemma3: N local layers per global
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: Optional[int] = None       # qwen3-moe: per-expert d_ff
    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0                      # Mamba2 state dim (zamba2)
    ssm_conv: int = 4                       # depthwise conv width
    ssm_expand: int = 2                     # Mamba inner expansion
    attn_every: int = 0                     # zamba2: shared attn block period
    slstm_every: int = 2                    # xlstm: sLSTM block period
    # --- enc-dec / multimodal ----------------------------------------------
    encoder_layers: int = 0                 # whisper encoder depth
    encoder_seq: int = 0                    # whisper: 1500 frames
    n_patches: int = 0                      # vlm: vision tokens prepended
    # --- misc ---------------------------------------------------------------
    mlp_gelu: bool = False                  # 2-matrix GELU MLP (starcoder2, whisper)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""                        # citation bracket from assignment

    # -- derived -------------------------------------------------------------
    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def eff_d_ff(self) -> int:
        """d_ff actually used by one expert (MoE) or the MLP (dense)."""
        if self.is_moe and self.expert_d_ff is not None:
            return self.expert_d_ff
        return self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (``long_500k``) is runnable."""
        if self.family in (SSM, HYBRID):
            return True
        if self.is_encdec:
            return False  # whisper decoder architecturally capped (~448 tok)
        return self.sliding_window is not None or self.local_global_pattern > 0

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        dh, H, KV = self.dh, self.n_heads, self.n_kv_heads
        p = self.vocab * d                       # embed
        if not self.tie_embeddings:
            p += self.vocab * d                  # lm head
        attn = d * H * dh + 2 * d * KV * dh + H * dh * d
        if self.qkv_bias:
            attn += (H + 2 * KV) * dh
        mats = 2 if self.mlp_gelu else 3         # GELU MLP vs SwiGLU
        if self.is_moe:
            mlp = self.n_experts * mats * d * self.eff_d_ff + d * self.n_experts
        elif self.family == SSM:
            mlp = 0  # xlstm: d_ff==0; block cost counted below
        else:
            mlp = mats * d * self.eff_d_ff
        norms = 2 * d
        if self.family == HYBRID:
            # Mamba2 block: in_proj (x,z,B,C,dt), conv, out_proj
            din = self.ssm_expand * d
            mamba = d * (2 * din + 2 * self.ssm_state + din // max(dh, 1) + 1) \
                + self.ssm_conv * din + din * d
            n_attn = L // self.attn_every if self.attn_every else 0
            n_mamba = L - n_attn
            p += n_mamba * (mamba + norms) + n_attn * (attn + mlp + norms)
            return p
        if self.family == SSM:
            # xLSTM: mLSTM qkv + gates + out; approx 8*d*d per block
            p += L * (8 * d * d + norms)
            return p
        p += L * (attn + mlp + norms)
        if self.is_encdec:
            enc_attn = 4 * d * d
            p += self.encoder_layers * (enc_attn + mlp + norms) \
                + L * (attn + mlp)               # cross-attn in decoder
        return p

    def n_active_params(self) -> int:
        """Activated params per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        mats = 2 if self.mlp_gelu else 3
        full_mlp = self.n_experts * mats * d * self.eff_d_ff
        act_mlp = self.top_k * mats * d * self.eff_d_ff
        return self.n_params() - L * (full_mlp - act_mlp)

    # -- smoke-test reduction --------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same family, CPU-sized: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 128)
        h = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, h))
        kv = h // max(1, h // kv)  # keep divisibility
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=h,
            n_kv_heads=kv,
            head_dim=d // h,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else None,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            local_global_pattern=min(self.local_global_pattern, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            name=self.name + "-reduced",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-step hyperparameters (shared by launcher + FL driver)."""
    optimizer: str = "adamw"        # "sgd" | "adamw"
    lr: float = 3e-4
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    remat: str = "none"             # "none" | "full" | "dots"
    microbatch: int = 0             # 0 = no grad accumulation
    dtype: str = "bfloat16"
    seed: int = 0
    # TRA-sparsified gradient collective (beyond-paper)
    tra_collective_drop: float = 0.0
    tra_debias: str = "per_coord_count"


# registry ------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)


ASSIGNED = (
    "qwen3-moe-235b-a22b", "gemma3-27b", "zamba2-7b", "qwen1.5-4b",
    "stablelm-3b", "starcoder2-15b", "internvl2-2b", "whisper-large-v3",
    "mixtral-8x22b", "xlstm-350m",
)


def _load_all() -> None:
    """Import the port's own config modules, one per assigned arch, and
    the token stand-in of ``synthetic_mlp``."""
    mods = [a.replace("-", "_").replace(".", "_") for a in ASSIGNED]
    for m in mods + ["synthetic_mlp"]:
        importlib.import_module(f"repro_torch.configs.{m}")
