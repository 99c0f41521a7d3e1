"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152; GQA + RoPE, bias enabled (starcoder2 uses bias).
[arXiv:2402.19173]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    use_bias=True,
    ffn_act="gelu",
    rope_theta=1_000_000.0,
)
