"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) vocab=151936;
128 experts, top-8, per-expert d_ff=768; qk-norm.  [hf:Qwen/Qwen3-30B-A3B]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    n_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
)
