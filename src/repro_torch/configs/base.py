"""Config system: one dataclass family covering all 10 assigned architectures.

Every architecture in ``repro_torch.configs`` instantiates :class:`ModelConfig`;
shapes come from :class:`ShapeConfig` (the four assigned input-shape sets).
``reduced()`` derives the CPU smoke-test variant of any config.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0              # always-on shared experts (qwen2-moe)
    dense_ff_parallel: int = 0     # arctic: parallel dense FFN width (0=off)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    pad_experts_to: int = 0        # pad expert count for EP divisibility


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    rope_head_dim: int
    nope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    headdim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qk_norm: bool = False
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_attn_every: int = 0     # zamba2: shared attn block every k layers
    n_encoder_layers: int = 0      # whisper encoder depth
    frontend: str | None = None    # None | 'audio' | 'vision' (stub embeddings)
    frontend_dim: int = 0          # stub embedding dim (0 => d_model)
    frontend_downsample: int = 1   # audio conv stack temporal downsample
    vision_tokens: int = 256       # patches per image (pixtral stub)
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"        # activation compute dtype
    param_dtype: str = "float32"   # parameter storage dtype
    # distribution / runtime knobs
    fsdp_pod: bool = False         # extend FSDP over the pod axis
    opt_state_dtype: str = "float32"
    remat: str = "full"            # none | full | selective
    grad_accum: int = 1
    seq_shard_cache: bool = False  # SP: shard decode KV cache over 'data'
    attn_impl: str = "ref"         # ref | blocked (online-softmax scan) | flash
    # §Perf knobs (baseline values first; see EXPERIMENTS.md §Perf)
    ce_impl: str = "onehot"        # gather (paper-baseline) | onehot
    moe_grouped: bool = False      # gshard group-local dispatch (EP all-to-all)
    ssd_matmul_dtype: str = "float32"  # intra-chunk einsum dtype (bf16 opt)
    # capability flags
    sub_quadratic: bool = False    # may run long_500k
    has_decoder: bool = True
    # dry-run/roofline calibration: Python-unroll the layer stack instead of
    # lax.scan (XLA cost_analysis counts scan bodies once, ignoring trip
    # count; unrolled lowerings give exact per-layer FLOPs/bytes/collectives)
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            head_dim=32,
            dtype="float32",
            param_dtype="float32",
            grad_accum=1,
            remat="none",
            ssd_matmul_dtype="float32",
        )
        if self.mla:
            changes["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                nope_head_dim=16, v_head_dim=32,
            )
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_expert=64, n_shared=min(self.moe.n_shared, 2),
                dense_ff_parallel=64 if self.moe.dense_ff_parallel else 0,
                pad_experts_to=0,
            )
        if self.ssm:
            changes["ssm"] = dataclasses.replace(self.ssm, d_state=16, headdim=16, chunk=32)
        if self.n_encoder_layers:
            changes["n_encoder_layers"] = 2
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        if self.frontend == "vision":
            changes["vision_tokens"] = 8
        if self.frontend_dim:
            changes["frontend_dim"] = 64
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The four assigned input-shape sets (LM-family shapes).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k needs sub-quadratic attention; decode
    shapes need a decoder."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: O(S^2) at 524k skipped (DESIGN.md §6)"
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""
