"""BONUS (beyond the assigned 10): mixtral-8x7b [moe] — 32L d_model=4096
32H (GQA kv=8) vocab=32000; 8 experts top-2, per-expert d_ff=14336.
[arXiv:2401.04088]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    capacity_factor=1.25,
    rope_theta=1_000_000.0,
)
