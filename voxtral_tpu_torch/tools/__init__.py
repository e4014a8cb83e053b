"""Command-line tools of the port (counterparts of the repo's `tools/`):

- `quantize`, `inspect_weights`: Q8 quantizer and safetensors inspector,
  numpy and host tensors only;
- `profile_q8_matmul_roofline`, `profile_weight_stream`,
  `profile_dma_ceiling`: the read ceilings and decode-matmul stacks on the
  card, each a function returning its numbers and a `main` that prints
  them (`python -m voxtral_tpu_torch.tools.<name>`).

Nothing runs at import.
"""
