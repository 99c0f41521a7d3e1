"""Architecture config schema for the model zoo (a copy of the JAX
package's ``configs/base.py``: pure data, no framework).

One frozen dataclass covers all six families (dense / moe / ssm / hybrid /
xlstm / audio / vlm). Every ``repro_torch/configs/<arch>.py`` file exports
``CONFIG`` with the exact published dimensions (source cited in the module
docstring); ``reduced()`` gives the smoke variant (2 layers, d_model <= 256,
<= 4 experts, float32) the CPU tests run. The port runs every family;
``chip_smoke.py`` runs full configs of each on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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

    # --- attention ---------------------------------------------------------
    head_dim: Optional[int] = None      # default d_model // n_heads
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q,k
    use_bias: bool = False
    rope_theta: float = 10_000.0
    attention: str = "full"             # full | sliding (beyond-paper variant)
    window: int = 4096                  # sliding-window size
    prefix_lm: bool = False             # paligemma: bidirectional prefix
    is_encoder: bool = False            # hubert: bidirectional, no decode

    # --- feed-forward ------------------------------------------------------
    ffn_act: str = "swiglu"             # swiglu | gelu (hubert) | geglu (gemma)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256                # SSD chunk length

    # --- hybrid (zamba2): one SHARED attention block every `attn_every`
    # mamba blocks (shared params, per-site KV cache) ------------------------
    attn_every: int = 0

    # --- xlstm: 1 sLSTM per `slstm_period` blocks (rest mLSTM) --------------
    slstm_period: int = 0

    # --- modality frontends (STUBS per brief) -------------------------------
    modality: str = "text"              # text | audio | vlm
    frontend_dim: int = 0               # audio: conv-feature dim fed to proj
    n_patches: int = 0                  # vlm: SigLIP patch embeddings count

    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"             # compute dtype; params and optimizer state f32
    remat: bool = True                  # activation checkpoint per block

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, self.name

    @property
    def d_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_ssm // self.ssm_head_dim

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = max(1, heads * self.n_kv_heads // self.n_heads)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=(
                min(self.experts_per_token, 2) if self.experts_per_token else 0
            ),
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=32 if self.ssm_state else 256,
            attn_every=1 if self.attn_every else 0,
            slstm_period=2 if self.slstm_period else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            window=64,
            remat=False,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned; see brief)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """Brief rules: encoders skip decode; long_500k needs sub-quadratic
    attention (SSM/hybrid run it; dense/vlm only via the sliding-window
    variant, which `models.build` switches on automatically for long_500k)."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch: no autoregressive decode step"
    return True, ""
