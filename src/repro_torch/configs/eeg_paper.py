"""The paper's own configuration (Jukic & Subasi 2017, Sec. 2.6):
Freiburg-style EEG, 256 Hz, 3 channels, 8-second windows (2048 samples),
8-minute matrices (2048 x 180), MSPCA denoise, level-4 db4 WPD features,
Rotation Forest, 3-of-5 alarm rule.
"""

from repro_torch.core.rotation_forest import RotationForestConfig
from repro_torch.signal.pipeline import PipelineConfig

SAMPLE_RATE_HZ = 256
WINDOW_SAMPLES = 2048            # 8 s
CHANNELS = 3
WINDOWS_PER_CHUNK = 60           # 8 min = 60 windows; matrix 2048 x 180
TRAIN_HOURS_INTERICTAL = 15
PREICTAL_MINUTES = 48

CONFIG = PipelineConfig(
    wpd_level=4,
    wavelet="db4",
    mspca_level=5,
    denoise=True,
    forest=RotationForestConfig(
        n_trees=10, n_subsets=3, depth=6, n_classes=2, n_bins=32
    ),
    alarm_k=3,
    alarm_m=5,
)
