from voxtral_tpu_torch.audio.mel import (
    MelStream, batch_log_mel, batch_log_mel_device, mel_filters, pad_audio_offline,
)
from voxtral_tpu_torch.audio.wav import (
    load_audio, load_wav, parse_wav_bytes, resample_linear,
)

__all__ = [
    "MelStream", "batch_log_mel", "batch_log_mel_device", "load_audio", "load_wav",
    "mel_filters", "pad_audio_offline", "parse_wav_bytes", "resample_linear",
]
