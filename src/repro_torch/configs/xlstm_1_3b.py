"""xlstm-1.3b [ssm] — 48 blocks, d_model=2048, 4 heads, vocab=50304;
xLSTM[7:1] — one sLSTM block per 8 (rest mLSTM matrix-memory blocks).
Blocks carry their own up-projection (d_ff=0 in the assignment).
[arXiv:2405.04517]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_period=8,
    ssm_expand=2,
    ssm_chunk=256,
)
