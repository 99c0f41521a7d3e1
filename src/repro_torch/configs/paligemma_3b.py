"""paligemma-3b [vlm] — gemma-2b language decoder consuming SigLIP patch
embeddings (vision tower STUBBED per brief; ``input_specs`` provides patch
embeddings).  18L d_model=2048 8H (GQA kv=1 = MQA) d_ff=16384 vocab=257216;
prefix-LM mask (bidirectional over image+prefix).  [arXiv:2407.07726]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    ffn_act="geglu",
    prefix_lm=True,
    modality="vlm",
    n_patches=256,
)
