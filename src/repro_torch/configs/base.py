"""Architecture configuration schema and registry of the LLM stack.

A copy of ``repro.configs.base`` (data and plain Python): the port
imports nothing of the JAX package, and the parity tests hold every
field, property and segment layout equal to the original.  One
difference: :attr:`ArchConfig.activation_dtype` is a ``torch.dtype``.

Every architecture is a single :class:`ArchConfig`; the transformer
(``models/transformer.py``) consumes it directly.  Layer heterogeneity
is expressed as *segments*: ``layer_segments() -> [(block descriptors,
repeat), ...]``, each segment holding its parameters stacked over
``repeat`` layers.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["ArchConfig", "BlockDesc", "ShapeSpec", "SHAPES",
           "cell_supported", "register", "get_config", "list_configs",
           "REGISTRY"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    """One decoder block position inside a segment."""
    mixer: Literal["attn", "mla", "ssm", "hybrid"] = "attn"
    mlp: Literal["swiglu", "geglu", "gelu", "moe", "none"] = "swiglu"
    window: int = 0          # 0 → global attention; >0 → sliding window
    rope_theta: float = 1e4  # per-block RoPE base (gemma3 differs L vs G)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encoder", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    # --- attention flavor ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True               # False for encoder-only (hubert)
    local_window: int = 0             # >0 enables SWA blocks
    local_global_pattern: tuple[int, int] = (0, 0)   # (n_local, n_global)
    global_layers: tuple[int, ...] = ()  # explicit global positions (hymba)
    # --- MLA (minicpm3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hymba) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # --- misc ---
    mlp_kind: Literal["swiglu", "geglu", "gelu", "none"] = "swiglu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    img_tokens: int = 0               # VLM: stub patch embeddings prefix
    frontend_dim: int = 0             # audio/vlm stub feature dim
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (padded logits are
        masked at sampling time)."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run 500k-token decode (SSM/hybrid/local)."""
        return (self.family in ("ssm", "hybrid")
                or self.local_global_pattern[0] > 0)

    def block(self, **over) -> BlockDesc:
        base = dict(
            mixer="mla" if self.mla else ("ssm" if self.ssm and not over.get(
                "mixer") else "attn"),
            mlp="moe" if self.moe else self.mlp_kind,
            window=0, rope_theta=self.rope_theta)
        base.update(over)
        return BlockDesc(**base)

    def layer_segments(self) -> list[tuple[tuple[BlockDesc, ...], int]]:
        """Segments of (block descriptors, repeat count)."""
        L = self.n_layers
        if self.family == "hybrid" or self.global_layers:
            # Explicit sparse global positions; everything else local hybrid.
            segs: list[tuple[tuple[BlockDesc, ...], int]] = []
            gl = sorted(self.global_layers)
            pos = 0
            mixer = "hybrid" if self.family == "hybrid" else "attn"
            for g in gl:
                if g > pos:
                    segs.append(((self.block(mixer=mixer,
                                             window=self.local_window),),
                                 g - pos))
                segs.append(((self.block(mixer=mixer, window=0),), 1))
                pos = g + 1
            if pos < L:
                segs.append(((self.block(mixer=mixer,
                                         window=self.local_window),),
                             L - pos))
            return segs
        nl, ng = self.local_global_pattern
        if nl and ng:
            group = (self.block(window=self.local_window),) * nl + (
                self.block(window=0, rope_theta=1e6),) * ng
            n_groups = L // (nl + ng)
            segs = [(group, n_groups)]
            rem = L - n_groups * (nl + ng)
            if rem:
                segs.append(((self.block(window=self.local_window),), rem))
            return segs
        return [((self.block(),), L)]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch × shape) is a runnable dry-run cell, with reason."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "needs sub-quadratic attention (full-attention arch)"
    return True, ""


REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        # late import of the config data
        import repro_torch.configs.archs  # noqa: F401
    return REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(REGISTRY)
