"""hubert-xlarge [audio] — encoder-only transformer backbone (same arch as
wav2vec2); 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (codebook
targets).  Conv feature extractor is a STUB per brief: ``input_specs``
provides precomputed frame features (B, S, frontend_dim) which the model
projects to d_model.  [arXiv:2106.07447]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    ffn_act="gelu",
    use_bias=True,
    modality="audio",
    frontend_dim=512,
)
