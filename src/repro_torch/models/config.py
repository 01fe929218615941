"""Model configuration schema: a jax-free copy of ``repro.models.config``.

The fields, defaults and derived quantities are the reference's, so a
config built here compares equal field for field with the reference's;
only ``compute_dtype`` maps to a torch dtype.

One ``ModelConfig`` describes any of: dense GQA decoder LMs, fine-grained
MoE, MoE + dense residual, Mamba-1 SSM, RG-LRU/local-attention hybrids,
encoder-decoder audio backbones, and VLM (prefix + decoder) backbones.
The port serves every family and runs its prefill and the loss's
forward; training comes with ROADMAP A13.2. ``reduced()`` derives the small same-family variant
used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static compression plan knobs (the paper's technique, per tensor
    class). ``None`` widths mean "leave at the compute dtype".

    Defaults follow the *high quality* operating point of Section 6.1 as
    tuned by ``repro.core.precision_tuning`` on the reduced models (see
    the reference's calibration notes): AF16 weights / AF16 KV /
    AF12+AF16 optimizer moments, with integer streams sized by range
    analysis.
    """

    weight_bits: Optional[int] = None      # packed param width (Table 3)
    kv_bits: Optional[int] = None          # packed KV-cache width
    grad_bits: Optional[int] = None        # gradient all-reduce width
    opt_m_bits: Optional[int] = None       # Adam first-moment width
    opt_v_bits: Optional[int] = None       # Adam second-moment width
    master_bits: Optional[int] = None      # master-weight width
    # speculative serving: width the *draft* model's weights repack to
    # (``core.compress.derive_plan``). None = one Table 3 ladder step
    # below ``weight_bits``; the draft proposes, the full-width target
    # verifies, so this knob trades acceptance rate for draft bytes/token
    # without ever changing emitted tokens.
    draft_weight_bits: Optional[int] = None
    # width the draft's *KV cache* packs at. None = one Table 3 ladder
    # step below ``kv_bits`` when the target packs its KV, else mirror
    # the target. Narrower draft KV shrinks the draft's bytes/token the
    # same way narrower draft weights do — and like them it only moves
    # the acceptance rate, never the emitted tokens.
    draft_kv_bits: Optional[int] = None
    # per-layer KV widths from the static activation-width analysis
    # (``CompressionPlan.kv_bits``), one entry per KV-carrying layer.
    # None = uniform at ``kv_bits``. When set, ``kv_bits`` must hold the
    # max of the tuple (allocation paths that need a single width — e.g.
    # the residency planner's worst case — read it); the decode state
    # segments layers by contiguous equal widths.
    kv_layer_bits: Optional[Tuple[int, ...]] = None

    @property
    def any_packing(self) -> bool:
        return any(
            b is not None
            for b in (self.weight_bits, self.kv_bits, self.grad_bits,
                      self.opt_m_bits, self.opt_v_bits, self.master_bits)
        )


HIGH_QUALITY_COMPRESSION = CompressionConfig(
    weight_bits=16, kv_bits=16, grad_bits=16,
    opt_m_bits=16, opt_v_bits=16, master_bits=None,
)
NO_COMPRESSION = CompressionConfig()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # dense features
    gated_mlp: bool = True         # SwiGLU vs plain GELU MLP
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    # SSM (mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0
    # hybrid (recurrentgemma)
    pattern_rec: int = 0           # recurrent layers per group
    pattern_attn: int = 0          # attention layers per group
    attn_window: int = 0           # local attention window (0 = full)
    lru_width: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # stub frontend output length
    # vlm (paligemma)
    num_image_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    compression: CompressionConfig = NO_COMPRESSION

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:       # mamba
        return self.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def recurrent(self) -> bool:
        """The SSM / hybrid families: decode folds every token into
        recurrent state, which has no KV rows to page or roll back."""
        return self.family in ("ssm", "hybrid")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.recurrent

    @property
    def has_decode(self) -> bool:
        return True                 # no encoder-only archs assigned

    @property
    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def resolved_kv_bits(self) -> int:
        """Bits per KV element for *bytes accounting*: the packed width
        when the KV cache packs, else 16 (the bf16 compute dtype). The
        single source of the ``or 16`` default — the residency planner
        and ``kv_bytes_per_token`` both read it, so a future default
        change cannot skew one side of the bytes accounting. (State
        *allocation* still keys off ``compression.kv_bits`` directly:
        None there means a dense cache, not a 16-bit packed one.)"""
        return self.compression.kv_bits or 16

    @property
    def n_kv_layers(self) -> int:
        """Layers that carry a per-token KV (or decode-attention) cache —
        the length a ``kv_layer_bits`` tuple must have."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            groups = self.n_layers // (self.pattern_rec + self.pattern_attn)
            return groups * self.pattern_attn
        return self.n_layers

    @property
    def resolved_kv_layer_bits(self) -> Tuple[int, ...]:
        """Per-layer KV widths for bytes accounting: the explicit
        ``kv_layer_bits`` tuple when the analysis emitted one, else
        ``resolved_kv_bits`` broadcast over every KV layer."""
        if self.compression.kv_layer_bits is not None:
            return tuple(self.compression.kv_layer_bits)
        return (self.resolved_kv_bits,) * self.n_kv_layers

    def kv_segments(self) -> Tuple[Tuple[int, int, int], ...]:
        """Contiguous equal-width layer runs as ``(start, end, bits)``
        half-open spans — the static segmentation the decode state and
        the per-segment decode scans share. A uniform config yields one
        segment covering every KV layer (the single-scan fast path)."""
        widths = self.resolved_kv_layer_bits
        segs = []
        for i, b in enumerate(widths):
            if segs and segs[-1][2] == b:
                segs[-1] = (segs[-1][0], i + 1, b)
            else:
                segs.append((i, i + 1, b))
        return tuple(segs)

    @property
    def resolved_weight_bits(self) -> int:
        """Bits per weight element for bytes accounting and for packing
        at the planned width: the configured width, else 16 (bf16)."""
        return self.compression.weight_bits or 16

    def n_params(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = (self.n_heads * hd * d) * 2 + (self.n_kv_heads * hd * d) * 2
        mlp = (3 if self.gated_mlp else 2) * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "dense":
            return self.n_layers * (attn + mlp) + emb
        if self.family == "moe":
            expert = 3 * d * self.moe_d_ff
            per_layer = attn + expert * (
                self.n_experts + self.n_shared_experts
            ) + d * self.n_experts  # router
            if self.dense_residual:
                per_layer += mlp
            return self.n_layers * per_layer + emb
        if self.family == "ssm":
            di, dtr, n = self.d_inner, self.resolved_dt_rank, self.ssm_state
            per_layer = (
                d * 2 * di + di * self.d_conv
                + di * (dtr + 2 * n) + dtr * di + di * d + di * 2 + di
            )
            return self.n_layers * per_layer + emb
        if self.family == "hybrid":
            lw = self.lru_width or d
            rec = 2 * d * lw + lw * self.d_conv + 3 * lw + lw * d
            groups = self.n_layers // (self.pattern_rec + self.pattern_attn)
            n_attn = groups * self.pattern_attn
            n_rec = self.n_layers - n_attn
            return n_rec * rec + n_attn * attn + self.n_layers * mlp + emb
        if self.family == "encdec":
            # encoder self-attn + dec self-attn + dec cross-attn + 2 MLPs
            return (
                self.encoder_layers * (attn + mlp)
                + self.n_layers * (2 * attn + mlp)
                + emb
            )
        if self.family == "vlm":
            return self.n_layers * (attn + mlp) + emb
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        """Per-token active params (= n_params for non-MoE)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        expert = 3 * d * self.moe_d_ff
        hd = self.resolved_head_dim
        attn = (self.n_heads * hd * d) * 2 + (self.n_kv_heads * hd * d) * 2
        per_layer = attn + expert * (
            self.experts_per_token + self.n_shared_experts
        ) + d * self.n_experts
        if self.dense_residual:
            per_layer += (3 if self.gated_mlp else 2) * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb

    def kv_bytes_per_token(self, bits: Optional[int] = None) -> int:
        """KV-cache (or state) bytes per token at the given packing.
        With no explicit ``bits`` and a per-layer ``kv_layer_bits``
        tuple, each layer contributes at its own width (mixed-width
        accounting); an explicit ``bits`` forces the uniform formula."""
        hd = self.resolved_head_dim
        if self.family == "ssm":
            return 0                # state is O(1) in sequence length
        row = 2 * self.n_kv_heads * hd
        if bits is None and self.compression.kv_layer_bits is not None:
            total = sum(row * b for b in self.resolved_kv_layer_bits)
            if self.family == "encdec":
                # cross-KV mirrors the decoder stack (dense-regioned,
                # same widths)
                total *= 2
            return total // 8
        b = bits or self.resolved_kv_bits
        if self.family == "hybrid":
            return self.n_kv_layers * row * b // 8
        layers = self.n_layers + (
            self.n_layers if self.family == "encdec" else 0
        )
        return layers * row * b // 8

    def reduced(self) -> "ModelConfig":
        """Same-family tiny variant for CPU smoke tests."""
        groups = max(
            self.n_layers // max(self.pattern_rec + self.pattern_attn, 1), 1
        )
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=(self.pattern_rec + self.pattern_attn) * 2
            if self.family == "hybrid" else 2,
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 2),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            dt_rank=8 if self.family == "ssm" else 0,
            lru_width=128 if self.lru_width else 0,
            attn_window=min(self.attn_window, 64),
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=32 if self.encoder_seq else 0,
            num_image_tokens=16 if self.num_image_tokens else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
