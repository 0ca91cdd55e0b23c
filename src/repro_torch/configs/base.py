"""Architecture & shape configuration system (PyTorch port).

The same ``ArchConfig`` / ``ShapeCfg`` dataclasses as the JAX package, copied so
the port imports nothing of it. ``input_specs`` returns ``(shape, dtype name)``
pairs in place of ``jax.ShapeDtypeStruct``; dtype names are spelled as the JAX
package spells them (``int32``, ``bfloat16``) so UPIR program text is identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# ------------------------------------------------------------------- sub-configs


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    """Mamba2-style SSD block geometry."""
    d_inner: int                   # expanded width (2*d_model typically)
    head_dim: int                  # P
    state_dim: int                 # N
    n_groups: int = 1              # G (B/C groups)
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclass(frozen=True)
class XLSTMCfg:
    slstm_every: int = 6           # block i is sLSTM iff i % slstm_every == 0
    chunk: int = 256               # mLSTM chunked-parallel chunk length
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333


@dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int
    enc_seq: int                   # encoder memory length (stub frontend output)


@dataclass(frozen=True)
class FrontendStub:
    """Modality frontend stub: input_specs() emits precomputed embeddings."""
    kind: str                      # "vision" | "audio"
    tokens: int                    # patches / frames emitted per example


# ------------------------------------------------------------------ arch config


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "silu"              # silu(glu) | gelu(glu) | gelu | relu2
    glu: bool = True
    tied_embeddings: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10000.0
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    encdec: Optional[EncDecCfg] = None
    frontend: Optional[FrontendStub] = None
    hybrid_attn_period: int = 0    # zamba2: shared attn block every k ssm blocks
    attn_window: int = 0           # sliding window (0 = full); used for long decode
    # training-system choices (scale-driven; see DESIGN.md §4)
    optimizer: str = "adamw"       # adamw | adafactor
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_hint: str = "auto"
    source: str = ""               # [citation; verification tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / linear-attention families."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * D
        head = 0 if self.tied_embeddings else D * V
        if self.family == "ssm" and self.xlstm is not None:
            per = _xlstm_block_params(self)
            return emb + head + per + D  # per already sums all blocks; +final norm
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
            + self.n_heads * hd * D
        mlp_mult = 3 if self.glu else 2
        if self.moe is not None:
            mlp = self.moe.num_experts * mlp_mult * D * self.moe.d_ff \
                + D * self.moe.num_experts
        else:
            mlp = mlp_mult * D * F
        norms = 2 * D
        per_layer = attn + mlp + norms
        if self.family == "hybrid" and self.ssm is not None:
            # L scanned Mamba2 blocks + ONE shared attention+MLP block (zamba2)
            ssm_per = _mamba_block_params(self)
            return emb + head + L * ssm_per + (attn + mlp_mult * D * F + norms) + D
        return emb + head + L * per_layer + D

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        D = self.d_model
        mlp_mult = 3 if self.glu else 2
        total = self.param_count()
        all_experts = self.n_layers * self.moe.num_experts * mlp_mult * D * self.moe.d_ff
        active = self.n_layers * self.moe.top_k * mlp_mult * D * self.moe.d_ff
        return total - all_experts + active


def _mamba_block_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner
    return (D * di * 2                      # w_x, w_z
            + D * 2 * s.n_groups * s.state_dim   # w_bc
            + D * s.n_heads                 # w_dt
            + s.conv_kernel * di            # conv
            + 2 * s.n_heads                 # A_log, D_skip
            + di                            # out norm
            + di * D                        # w_out
            + D)                            # ln


def _xlstm_block_params(cfg: ArchConfig) -> int:
    x = cfg.xlstm
    D = cfg.d_model
    H = cfg.n_heads
    total = 0
    for i in range(cfg.n_layers):
        if i % x.slstm_every == 0:
            dh = D // H
            cell = 4 * (D * D + H * dh * dh) + 4 * D   # input + block-diag recurrent + bias
            ff = int(2 * D * D * x.proj_factor_slstm)
            total += cell + ff + 2 * D
        else:
            di = int(D * x.proj_factor_mlstm)
            total += D * 2 * di + 3 * di * di + 2 * di * H + di + di * D + D
    return total


# ------------------------------------------------------------------------ shapes


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1, long_context=True),
}


def cell_supported(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs, and why not if skipped."""
    if shape.long_context and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic sequence handling; "
                       f"{cfg.name} is pure full-attention (see DESIGN.md §4)")
    return True, ""


# -------------------------------------------------------------------- input specs

Spec = Tuple[Tuple[int, ...], str]


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Spec]:
    """``(shape, dtype name)`` stand-ins for every model input of this cell.

    Training: token/label batch. Prefill: token batch. Decode: one-token batch +
    position. Modality frontends are stubs: precomputed embeddings are inputs.
    """
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Spec] = {}
    if shape.kind == "train":
        specs["tokens"] = ((B, S), "int32")
        specs["targets"] = ((B, S), "int32")
    elif shape.kind == "prefill":
        specs["tokens"] = ((B, S), "int32")
    else:  # decode
        specs["tokens"] = ((B, 1), "int32")
        specs["pos"] = ((B,), "int32")
    if cfg.frontend is not None and shape.kind in ("train", "prefill"):
        specs[f"{cfg.frontend.kind}_embeds"] = (
            (B, cfg.frontend.tokens, cfg.d_model), "bfloat16")
    if cfg.encdec is not None and shape.kind == "decode":
        specs["encoder_memory"] = ((B, cfg.encdec.enc_seq, cfg.d_model),
                                   "bfloat16")
    return specs
