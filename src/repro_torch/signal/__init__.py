from repro_torch.signal import eeg_data, features, frontend, mspca, pipeline, wavelet

__all__ = ["eeg_data", "features", "frontend", "mspca", "pipeline", "wavelet"]
