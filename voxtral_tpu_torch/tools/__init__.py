"""Command-line tools of the port (counterparts of the repo's `tools/`):

- `quantize`, `inspect_weights`: Q8 quantizer and safetensors inspector,
  numpy and host tensors only;
- `profile_q8_matmul_roofline`, `profile_weight_stream`,
  `profile_dma_ceiling`: the read ceilings and decode-matmul stacks on the
  card; `profile_int4_unpack`, `profile_attn_layout`: the decode attention
  on int8 against nibble-packed rings, and on [B, P, kv_dim] against
  block-major rings. Each is a function returning its numbers and a
  `main` that prints them (`python -m voxtral_tpu_torch.tools.<name>`).

Nothing runs at import.
"""
