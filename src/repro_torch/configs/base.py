"""Architecture configuration schema (copy of ``repro.configs.base.
ArchConfig``, every field kept so that configs read the same in both
packages).  ``reduced()`` yields the tiny same-family config of the CPU
tests.  ``ShapeConfig`` and ``SHAPES`` are the reference's (arch x shape)
cells; the data stream and the trainer take a ``ShapeConfig``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE FFN every n-th layer (1 = all layers)
    capacity_factor: float = 1.25

    # --- SSM (Mamba) ---
    ssm_state: int = 0
    ssm_version: int = 1        # 1 = Mamba-1 (falcon-mamba), 2 = SSD (zamba2)
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0          # Mamba-2 heads (0 -> d_inner // 64)

    # --- hybrid (zamba2): one SHARED attention block every attn_every layers
    attn_every: int = 0         # 0 = attention in every layer (std dense)
    shared_attn: bool = False

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0     # >0 = enc-dec
    max_target_len: int = 448   # whisper decoder context

    # --- long context ---
    long_context: str = "skip"  # skip | native | window
    window: int = 4096          # sliding window used at long_500k

    # --- misc ---
    act: str = "swiglu"         # swiglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    frontend: str = "none"      # none | audio_frames | vq_tokens
    dtype: str = "bfloat16"

    # --- performance levers of the JAX package (kept for parity) ---
    ssm_unroll: int = 8
    ssm_impl: str = "scan"      # scan | ssd (Mamba-2; "ssd" serves only)
    ssd_chunk: int = 128
    head_pad: int = 0
    moe_dispatch: str = "global"
    flash_bwd: str = "recompute"
    zero2: bool = False
    remat_policy: str = "full"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))
        if self.family in ("moe",) and (self.n_experts == 0
                                        or self.top_k == 0):
            raise ValueError(f"{self.name}: moe family needs n_experts/top_k")
        if self.family in ("ssm", "hybrid") and self.ssm_state == 0:
            raise ValueError(f"{self.name}: ssm family needs ssm_state")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(self.d_inner // 64, 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.attn_every:
            return self.n_layers // self.attn_every
        return self.n_layers

    def pattern_period(self) -> int:
        """Length of the repeating layer pattern (the unit stacked over
        repeats)."""
        p = 1
        if self.n_experts and self.moe_every > 1:
            p = self.moe_every
        if self.attn_every:
            p = self.attn_every
        if self.n_layers % p:
            raise ValueError(f"{self.name}: n_layers % pattern != 0")
        return p

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = self.pattern_period()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 * period,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=2 if self.ssm_state else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            window=64,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Shapes: every LM arch is paired with these four cells (copy of
# ``repro.configs.base.ShapeConfig`` and ``SHAPES``).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}


def runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; else the documented skip
    (the reference's words)."""
    if shape.kind == "long_decode" and arch.long_context == "skip":
        return False, (
            f"{arch.name} is pure full-attention; 512k decode needs "
            "sub-quadratic attention (DESIGN.md §4)"
        )
    return True, ""
