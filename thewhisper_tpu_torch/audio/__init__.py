from thewhisper_tpu_torch.audio.features import (  # noqa: F401
    LogMelFeaturizer,
    hann_window,
    log_mel_spectrogram,
    mel_filter_bank,
)
from thewhisper_tpu_torch.audio.io import load_audio, resample, wav_bytes  # noqa: F401
