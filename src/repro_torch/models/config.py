"""Architecture configuration (port of ``repro.models.config``): the
reference's dataclass, copied field for field so a configuration and
its derived sizes (``d_inner``, ``ssm_n_heads``, ``n_params``) read the
same in both packages. Per-arch instances live in
:mod:`repro_torch.configs`; only mamba2-780m is ported so far."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "vlm", "hybrid", "audio", "ssm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family

    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    mlp: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    rope_style: Literal["standard", "mrope", "none"] = "standard"
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w splits
    norm_eps: float = 1e-6
    sliding_window: int | None = None  # SWA width (mixtral)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # hybrid (recurrentgemma): layer i is local-attn iff (i % 3 == 2)
    hybrid_pattern: int = 0  # 0 = not hybrid; 3 = 1 attn per 3 layers
    lru_width: int = 0
    local_window: int = 2048

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # stubbed conv-frontend output frames
    max_target_len: int = 448

    # vlm stub
    n_patches: int = 0  # patch embeds prepended by the stub frontend

    # numerics / runtime
    dtype: str = "bfloat16"
    remat: Literal["none", "selective", "full"] = "selective"
    # Dry-run analysis mode: python-unroll layer/attention loops so the
    # compiled HLO's cost_analysis counts EVERY iteration (XLA reports a
    # while-loop body once). Semantically identical; used only when
    # lowering for the roofline, never for execution.
    analysis_unroll: bool = False
    # Perf knob: statically skip fully-masked (above-diagonal) attention
    # blocks — requires the unrolled attention path.
    attn_block_skip: bool = False

    # which technique integrations apply (DESIGN.md §Arch-applicability)
    uses_stencil_kernel: bool = False

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:  # ssm
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def n_params(self) -> float:
        """Total parameter count (analytic; used for 6·N·D model FLOPs)."""
        d, hd = self.d_model, self.hd
        p = self.vocab * d  # embed
        if not self.tie_embeddings:
            p += self.vocab * d
        if self.family == "ssm":
            dv = self.d_inner
            conv_ch = dv + 2 * self.ssm_n_groups * self.ssm_state
            per = (
                d * (2 * dv + 2 * self.ssm_n_groups * self.ssm_state
                     + self.ssm_n_heads)  # in_proj
                + conv_ch * self.ssm_conv_kernel
                + 2 * self.ssm_n_heads  # A_log, D
                + dv  # norm
                + dv * d  # out_proj
                + d  # ln
            )
            return p + self.n_layers * per
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        def ffn(ff):
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            return mult * d * ff
        per = attn + 2 * d  # norms
        if self.family == "moe":
            per += d * self.n_experts + self.n_experts * ffn(self.d_ff_expert)
        else:
            per += ffn(self.d_ff)
        total = p + self.n_layers * per + d
        if self.hybrid_pattern:
            # recurrent layers replace attention with conv + RG-LRU
            n_rec = self.n_layers - self.n_layers // self.hybrid_pattern
            w = self.lru_width or d
            rec = d * w * 2 + w * 4 + w * d + 4 * w  # in/out proj + gates
            total += n_rec * (rec - attn)
        if self.is_encdec:
            # encoder blocks + decoder cross-attention
            total += self.n_encoder_layers * (attn + ffn(self.d_ff) + 2 * d)
            total += self.n_layers * attn  # cross-attn per decoder layer
        return float(total)

    def n_active_params(self) -> float:
        """Active per-token params (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        def ffn(ff):
            return 3 * self.d_model * ff
        inactive = (self.n_experts - self.top_k) * ffn(self.d_ff_expert)
        return self.n_params() - self.n_layers * inactive
