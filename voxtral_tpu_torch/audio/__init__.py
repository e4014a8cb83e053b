from voxtral_tpu_torch.audio.mel import batch_log_mel, pad_audio_offline

__all__ = ["batch_log_mel", "pad_audio_offline"]
