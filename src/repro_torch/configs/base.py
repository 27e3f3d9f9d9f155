"""Model / run configuration schema — a copy of the JAX package's
``configs/base.py`` (pure Python data; the port imports nothing of it).

One frozen dataclass describes every assigned architecture (and VGG-16 for
the paper's own experiment).  Heterogeneous layer stacks (jamba's 1:7
attn:mamba interleave, gemma3's 5:1 local:global, llama4's alternating
dense/MoE) are expressed with a cyclic ``layer_pattern`` plus a cyclic MoE
placement (``moe_every``/``moe_offset``); the model builder turns this into
homogeneous segments (see ``repro_torch.models.transformer``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Sequence

# Sub-layer mixer kinds usable in ``layer_pattern``.
MIXERS = ("attn", "attn_local", "attn_chunked", "mamba")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm | cnn

    # ---- trunk dimensions ---------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # ---- attention ----------------------------------------------------------
    layer_pattern: tuple[str, ...] = ("attn",)
    window_size: int = 1024  # sliding window for attn_local
    chunk_size: int = 8192  # chunk width for attn_chunked (llama4 iRoPE)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0

    # ---- MLP / MoE ----------------------------------------------------------
    ffn_act: str = "swiglu"  # swiglu | gelu | relu
    n_experts: int = 0  # 0 => dense MLP everywhere
    top_k: int = 1
    moe_every: int = 1  # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    dense_residual_ff: int = 0  # arctic: parallel dense MLP width (0 = none)
    capacity_factor: float = 2.0
    moe_group_size: int = 512  # GShard-style group-limited routing

    # ---- SSM (mamba-1) ------------------------------------------------------
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 => ceil(d_model / 16)

    # ---- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # ---- modality frontend (STUB per task spec) -----------------------------
    frontend: str = ""  # "" | "vision" | "audio"
    frontend_len: int = 0  # prefix positions fed as precomputed embeddings

    # ---- misc ---------------------------------------------------------------
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # Max positions a serve-time KV cache is allocated for (decode shapes
    # override this per run).
    max_seq_len: int = 32_768

    # ---- switches of a published model the reference's schema lacks --------
    # Class-level, not fields, so that a registry config's fields (and its
    # ``dataclasses.asdict``) stay the JAX package's; :class:`JambaConfig`
    # makes them fields.
    rope: ClassVar[bool] = True  # rotate q and k (False: no positional encoding)
    moe_renormalize: ClassVar[bool] = True  # top-k gates rescaled to sum to 1
    ssm_inner_norms: ClassVar[bool] = False  # RMSNorm of dt, B and C after x_proj

    # ------------------------------------------------------------------------
    def __post_init__(self):
        for mixer in self.layer_pattern:
            if mixer not in MIXERS:
                raise ValueError(f"unknown mixer {mixer!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # ---- derived ------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    def mixer_of(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.n_experts <= 1:
            return False
        return layer_idx % self.moe_every == self.moe_offset

    @property
    def pattern_period(self) -> int:
        """Smallest period after which (mixer, is_moe) repeats."""
        p = len(self.layer_pattern)
        if self.n_experts > 1:
            p = math.lcm(p, self.moe_every)
        return p

    def sublayer_kinds(self, start: int, count: int) -> tuple[tuple[str, bool], ...]:
        """(mixer, is_moe) for layers [start, start+count)."""
        return tuple(
            (self.mixer_of(i), self.is_moe_layer(i)) for i in range(start, start + count)
        )

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) --------------
    def param_counts(self) -> dict[str, float]:
        """Analytic parameter counts: total and *active* (MoE top-k) params."""
        d, hd = self.d_model, self.resolved_head_dim
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        mult = 2 if self.ffn_act in ("swiglu", "geglu") else 1
        dense_mlp = (mult + 1) * d * self.d_ff
        expert_mlp = (mult + 1) * d * self.d_ff  # per expert
        router = d * self.n_experts
        mamba = (
            d * 2 * self.d_inner  # in_proj
            + self.d_inner * self.ssm_conv  # depthwise conv
            + self.d_inner * (self.dt_rank + 2 * self.ssm_state)  # x_proj
            + self.dt_rank * self.d_inner  # dt_proj
            + self.d_inner * self.ssm_state  # A_log
            + self.d_inner  # D
            + self.d_inner * d  # out_proj
            + (self.dt_rank + 2 * self.ssm_state if self.ssm_inner_norms else 0)
        )
        total = active = 0.0
        n_dec = self.n_layers
        for i in range(n_dec):
            mixer = self.mixer_of(i)
            if mixer == "mamba":
                total += mamba
                active += mamba
            else:
                total += attn
                active += attn
            if self.is_moe_layer(i):
                total += router + self.n_experts * expert_mlp
                active += router + self.top_k * expert_mlp
                if self.dense_residual_ff:
                    dr = (mult + 1) * d * self.dense_residual_ff
                    total += dr
                    active += dr
            else:
                total += dense_mlp
                active += dense_mlp
            total += 2 * d  # norms
            active += 2 * d
        if self.is_encoder_decoder:
            enc = self.n_enc_layers * (attn + dense_mlp + 2 * d)
            xattn = n_dec * (d * q_dim + 2 * d * kv_dim + q_dim * d + d)
            total += enc + xattn
            active += enc + xattn
        emb = self.vocab_size * d
        total += emb + (0 if self.tie_embeddings else emb)
        active += emb + (0 if self.tie_embeddings else emb)
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    """The published Jamba (arXiv:2403.19887, 2408.12570; the layer equations
    of transformers' ``models/jamba/modeling_jamba.py``): its attention
    takes no rotary embedding, its MoE keeps the top-k softmax probabilities
    as the gates without renormalising them, and its Mamba mixer
    RMS-normalises dt, B and C after ``x_proj``.  The three switches are
    fields here, defaulting to Jamba's.  (The registry's
    ``jamba-1.5-large-398b`` is the JAX package's jamba, a plain
    :class:`ModelConfig` with none of the three.)"""

    rope: bool = False
    moe_renormalize: bool = False
    ssm_inner_norms: bool = True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs orthogonal to the model definition (perf levers)."""

    microbatches: int = 1  # gradient-accumulation steps inside train_step
    remat: str = "dots"  # "none" | "dots" | "full"  activation checkpointing
    opt_state_dtype: str = "float32"  # bf16 for the >100B models
    use_pallas: bool = False  # planner may force fused kernels on
    attn_chunk_q: int = 1024  # online-softmax q block
    attn_chunk_kv: int = 1024  # online-softmax kv block
    xent_chunk: int = 512  # chunked cross-entropy sequence block
    mamba_chunk: int = 256  # chunked selective-scan block
    seq_shard: bool = False  # sequence parallelism for long-context decode
    # §Perf levers (hillclimb iterations; see EXPERIMENTS.md §Perf)
    flash_vjp: bool = False  # custom-vjp flash attention (no AD-saved tiles)
    attn_bf16_tiles: bool = False  # bf16 probability tiles for PV/dV matmuls
    local_ring_cache: bool = False  # window-sized KV cache for local layers
    shard_grads: bool = False  # pin micro-grads to param sharding (=> RS not AR)
    fsdp: bool = True  # ZeRO-3 weight sharding (off for serving: pure TP)
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_compression: str = "none"  # "none" | "int8" (cross-pod error-feedback)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the *structure* (pattern, MoE placement, GQA ratio, enc-dec,
    frontend) while shrinking every dimension.
    """
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    small_heads = max(ratio, 2)
    small: dict = dict(
        n_layers=min(cfg.n_layers, 2 * cfg.pattern_period),
        d_model=64,
        n_heads=small_heads,
        n_kv_heads=max(small_heads // ratio, 1),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        head_dim=32,
        window_size=min(cfg.window_size, 16),
        chunk_size=min(cfg.chunk_size, 16),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_group_size=16,
        dense_residual_ff=64 if cfg.dense_residual_ff else 0,
        ssm_state=min(cfg.ssm_state, 8),
        ssm_dt_rank=4,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        frontend_len=min(cfg.frontend_len, 4) if cfg.frontend else 0,
        max_seq_len=64,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
