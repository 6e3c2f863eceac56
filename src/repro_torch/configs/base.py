"""Configuration schema of the port's language models.

The port's own copy of the reference package's ``configs/base.py`` (the
port never imports it): every architecture is a frozen ``ModelConfig``
that drives ``repro_torch.models`` with no per-arch model code. Layer
stacking is a repeating *pattern unit* (a tuple of ``LayerSpec``), applied
unit by unit over params that carry a leading ``n_units`` axis. Field
names, defaults, ``smoke()`` and ``param_count`` equal the reference's,
so a config of either package describes the same model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

ATTN = "attn"
RGLRU = "rglru"
SSD = "ssd"


@dataclass(frozen=True)
class LayerSpec:
    """One block position inside the repeating pattern unit."""

    kind: str = ATTN            # "attn" | "rglru" | "ssd"
    window: Optional[int] = None  # sliding-window size; None = global attention

    def __post_init__(self):
        if self.kind not in (ATTN, RGLRU, SSD):
            raise ValueError(f"unknown layer kind {self.kind!r}")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    load_balance_weight: float = 0.01
    capacity_factor: float = 1.25   # >= n_experts/top_k -> dropless
    group_tokens: int = 8192        # dispatch group size (GShard G axis);
                                    # bounds the (g, E, C) dispatch tensors
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    d_head: int = 64
    d_conv: int = 4
    chunk: int = 128              # SSD chunk length (MXU-aligned)


@dataclass(frozen=True)
class RecurrentConfig:
    rnn_width: int = 2560
    d_conv: int = 4
    c_const: float = 8.0          # RG-LRU exponent constant


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(ATTN),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    recurrent: Optional[RecurrentConfig] = None

    norm: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_nonparam
    mlp_act: str = "swiglu"       # swiglu | gelu
    qk_norm: bool = False
    use_rope: bool = True
    abs_sinusoidal: bool = False  # musicgen-style additive position embedding
    rope_theta: float = 10000.0
    embed_scale: bool = False     # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False
    logit_softcap: float = 0.0    # gemma-style tanh soft-capping (0 = off)

    frontend: Optional[str] = None   # None | "vision" | "audio"
    n_frontend_tokens: int = 0       # prepended patch/frame embeddings (stub)

    # numerics
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # parameter storage dtype
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8" (quantised cache)

    # implementation switches
    # "reference" (plain) | "pallas" | "chunked"; in the port the last two
    # both run the flash-attention kernel (models/attention.py)
    attn_impl: str = "reference"
    remat: str = "full"              # none | full | dots  (activation ckpt)
    grad_accum: int = 1              # microbatch accumulation steps

    # distribution knobs (consumed by repro.dist.sharding)
    fsdp: bool = False               # shard params over the data axis too
    zero_opt: bool = True            # shard optimizer state over data axis
    opt_state_dtype: str = "float32"

    # ----- derived -----
    @property
    def unit_len(self) -> int:
        return len(self.pattern)

    @property
    def n_units(self) -> int:
        return self.n_layers // self.unit_len

    @property
    def n_remainder(self) -> int:
        return self.n_layers % self.unit_len

    @property
    def remainder_pattern(self) -> Tuple[LayerSpec, ...]:
        return self.pattern[: self.n_remainder]

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.d_head

    @property
    def has_attention(self) -> bool:
        return any(s.kind == ATTN for s in self.pattern)

    @property
    def max_window(self) -> Optional[int]:
        """Largest attention window; None if any attention layer is global."""
        windows = [s.window for s in self.pattern if s.kind == ATTN]
        if not windows:
            return 0
        if any(w is None for w in windows):
            return None
        return max(windows)

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer needs an unbounded KV cache (long_500k eligible)."""
        return self.max_window is not None

    @property
    def supports_long_context(self) -> bool:
        # gemma3 keeps 1 global layer per unit but the 5 local layers bound the
        # bulk of the cache; per the assignment hybrid/windowed archs run
        # long_500k while *pure* full-attention archs skip it.
        windows = [s.window for s in self.pattern if s.kind == ATTN]
        if not windows:            # attention-free => trivially long-context
            return True
        n_global = sum(1 for w in windows if w is None)
        return n_global < len(windows) or len(windows) < len(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A reduced config of the same family for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        kw = dict(
            attn_impl="reference",
            kv_cache_dtype="bfloat16",   # exact decode parity in tests
            n_layers=min(self.n_layers, 2 * self.unit_len),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            dtype="float32",
            param_dtype="float32",
            n_frontend_tokens=4 if self.frontend else 0,
        )
        # shrink windows so tests exercise the masking path
        pat = tuple(
            LayerSpec(s.kind, None if s.window is None else min(s.window, 8))
            for s in self.pattern
        )
        kw["pattern"] = pat
        if self.moe is not None:
            n_e = min(self.moe.n_experts, 4)
            # dropless capacity so smoke tests check exact train/decode parity
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=n_e, d_ff_expert=64,
                capacity_factor=float(n_e) / self.moe.top_k,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, d_head=16, chunk=8
            )
        if self.recurrent is not None:
            kw["recurrent"] = dataclasses.replace(self.recurrent, rnn_width=64)
        return self.replace(**kw)


# ---------------------------------------------------------------------------
# Input shapes (the assigned shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[InputShape, ...]:
    """Shapes that run for this arch (long_500k only for sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter counting (for roofline MODEL_FLOPS = 6·N·D)
# ---------------------------------------------------------------------------


def param_count(cfg: ModelConfig) -> dict:
    """Analytic parameter counts: total and per-token-active (MoE-aware)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def attn_params():
        p = D * H * Dh + 2 * D * K * Dh + H * Dh * D
        if cfg.qk_norm:
            p += 2 * Dh
        return p

    def mlp_params(f):
        if f == 0:
            return 0
        mult = 3 if cfg.mlp_act == "swiglu" else 2
        return mult * D * f

    def norm_params():
        return 0 if cfg.norm == "layernorm_nonparam" else D

    total = 0
    active = 0
    layers = list(cfg.pattern) * cfg.n_units + list(cfg.remainder_pattern)
    for spec in layers:
        if spec.kind == ATTN:
            p = attn_params() + 2 * norm_params()
            total += p
            active += p
            if cfg.moe is not None:
                e = cfg.moe
                expert = mlp_params(e.d_ff_expert)
                total += D * e.n_experts + e.n_experts * expert
                active += D * e.n_experts + e.top_k * expert
                if e.dense_residual:
                    total += mlp_params(F)
                    active += mlp_params(F)
            else:
                total += mlp_params(F)
                active += mlp_params(F)
        elif spec.kind == RGLRU:
            R = cfg.recurrent.rnn_width
            p = 2 * D * R + R * D + 2 * R + cfg.recurrent.d_conv * R
            p += norm_params() + mlp_params(F) + norm_params()
            total += p
            active += p
        elif spec.kind == SSD:
            s = cfg.ssm
            d_in = s.expand * D
            d_xbc = d_in + 2 * s.d_state
            n_h = d_in // s.d_head
            p = D * (2 * d_in + 2 * s.d_state + n_h)   # in_proj (z,x,B,C,dt)
            p += s.d_conv * d_xbc                       # conv
            p += 2 * n_h + d_in                         # A_log, D skip, gate-norm
            p += d_in * D                               # out_proj
            p += norm_params()
            total += p
            active += p
    emb = V * D
    total += emb + norm_params()
    active += norm_params()
    # embedding lookup is sparse; lm head matmul is dense-active
    if not cfg.tie_embeddings:
        total += D * V
    total_with_emb = total
    active += D * V  # lm head
    return {
        "total": int(total_with_emb),
        "active": int(active),
        "embedding": int(emb),
    }
