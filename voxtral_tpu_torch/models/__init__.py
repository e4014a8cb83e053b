from voxtral_tpu_torch.models.encoder import conv_stem, encoder_forward
from voxtral_tpu_torch.models.adapter import adapter_forward
from voxtral_tpu_torch.models.decoder import (
    DecodeState, init_decode_state, decoder_prefill, decode_scan,
    time_conditioning, ada_scales,
)
from voxtral_tpu_torch.models.pipeline import transcribe_tokens_batch

__all__ = [
    "conv_stem", "encoder_forward", "adapter_forward", "DecodeState",
    "init_decode_state", "decoder_prefill", "decode_scan",
    "time_conditioning", "ada_scales", "transcribe_tokens_batch",
]
