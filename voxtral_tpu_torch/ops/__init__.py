from voxtral_tpu_torch.ops.norms import rms_norm
from voxtral_tpu_torch.ops.rope import rope_angles, apply_rope
from voxtral_tpu_torch.ops.attention import windowed_attention, ring_decode_attention
from voxtral_tpu_torch.ops.conv import causal_conv1d

__all__ = [
    "rms_norm", "rope_angles", "apply_rope",
    "windowed_attention", "ring_decode_attention", "causal_conv1d",
]
