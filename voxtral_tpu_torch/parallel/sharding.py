"""Mesh and sharding rules: tensor parallelism (TP) over attention heads,
FFN columns and the vocabulary, data parallelism (DP) over concurrent
streams (counterpart of `voxtral_tpu/parallel/sharding.py`).

The JAX package places whole arrays with NamedShardings and lets GSPMD
insert the collectives. Here every rank holds only its own contiguous
slices, and the model code runs the collectives itself through a
`TensorParallel` (torch.distributed: gloo on the CPU; NCCL across cards,
or gloo on CUDA tensors, which it stages through the host, for ranks that
share one card). The layout is the JAX package's, on the per-layer
param tree:
- wq/wk/wv, w1/w3, adapter w0: column-sharded (output / head axis on
  'model'), with their biases (encoder wq_b, wv_b);
- wo, w2, adapter w1: row-sharded (input axis on 'model'), the partial
  products summed by an all-reduce over 'model', then the replicated bias
  (wo_b, w2_b) added once;
- embed: vocab-sharded (axis 0). The lookup gives zero rows for ids
  outside the rank's range, then an all-reduce (exact: one rank
  contributes each row); the greedy head merges each rank's (best logit,
  index + offset), the top-k path all-gathers the logits;
- norms, the conv stem, the ada MLP: replicated;
- KV rings [B, P, heads*hd] and scale tables [B, heads, P]: sharded over
  (kv) heads, built rank-local (int4-packed lanes are head-major, so a
  head-aligned split stays head-local);
- all stream state: sharded over 'data' on the leading batch axis, built
  rank-local. Streams never talk to each other except through the shared
  lockstep cursor: its advance (the longest active prefix) is a max over
  the data group.

A Q8 weight's scale vector follows the axis it scales: axis 0 for the
embedding, the last axis otherwise, so column-sharded weights slice their
scales and row-sharded ones keep them whole.

The JAX module's `use_tp_mesh`, `tp_scoped_jit` and `active_tp_mesh`
(:39-100) steer JAX tracing and jit caches (a `pallas_call` must be traced
inside `shard_map`); eager PyTorch has nothing to trace, so they have no
counterpart: the model functions take the `TensorParallel` as an argument.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.ops.ring_attention import local_heads
from voxtral_tpu_torch.quant import Quantized

DATA, MODEL = "data", "model"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on a ('data', 'model') mesh and the two process
    groups the model code reduces over. Groups may be None when their size
    is 1 (or for slicing only, as `shard_params` does)."""
    model_rank: int = 0
    model_size: int = 1
    data_rank: int = 0
    data_size: int = 1
    model_group: object = None
    data_group: object = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of x over the model group (x itself when the group is one
        rank). x is reduced in place when contiguous."""
        if self.model_size == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x, group=self.model_group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's x concatenated along `dim` in rank order."""
        if self.model_size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.model_size)]
        dist.all_gather(parts, x.contiguous(), group=self.model_group)
        return torch.cat(parts, dim=dim)

    def data_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max of x over the data group (the lockstep cursor's advance)."""
        if self.data_size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.data_group)
        return x

    def local_batch(self, batch: int) -> int:
        if batch % self.data_size:
            raise ValueError(f"batch {batch} is not a multiple of the data axis "
                             f"{self.data_size}")
        return batch // self.data_size

    def local(self, cfg: VoxtralConfig) -> VoxtralConfig:
        """The config of this rank's slice: heads, kv heads, FFN and adapter
        hidden widths and the vocabulary divided by the model axis (every
        other field, the streaming ids included, stays global)."""
        m = self.model_size
        if m == 1:
            return cfg
        e, d = cfg.encoder, cfg.decoder
        for what, n in (("encoder hidden", e.hidden), ("decoder hidden", d.hidden),
                        ("adapter hidden", cfg.adapter_hidden), ("vocab", d.vocab_size)):
            if n % m:
                raise ValueError(f"{what} {n} is not divisible by the model axis {m}")
        e_heads, _ = local_heads(e.heads, e.heads, m)
        d_heads, d_kv = local_heads(d.heads, d.kv_heads, m)
        return dataclasses.replace(
            cfg, encoder=dataclasses.replace(e, heads=e_heads, hidden=e.hidden // m),
            decoder=dataclasses.replace(d, heads=d_heads, kv_heads=d_kv, hidden=d.hidden // m,
                                        vocab_size=d.vocab_size // m),
            adapter_hidden=cfg.adapter_hidden // m)


def make_mesh(n_data: int, n_model: int, device_type: str = "cuda") -> TensorParallel:
    """This rank's TensorParallel on an (n_data, n_model) mesh of the
    initialised default process group (`init_device_mesh`, dims ('data',
    'model'); ranks are laid out row-major, as the JAX `make_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda":           # ranks share the cards round-robin
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mesh = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA, MODEL))
    return TensorParallel(model_rank=mesh.get_local_rank(MODEL), model_size=n_model,
                          data_rank=mesh.get_local_rank(DATA), data_size=n_data,
                          model_group=mesh.get_group(MODEL), data_group=mesh.get_group(DATA))


def param_shard_dims(cfg: VoxtralConfig) -> dict:
    """The param tree's layout: each leaf is the axis sharded over 'model',
    or None (replicated). The JAX `param_pspecs`' tree."""
    enc_layer = {
        "attn_norm": None, "ffn_norm": None,
        "wq": 1, "wq_b": 0, "wk": 1, "wv": 1, "wv_b": 0,
        "wo": 0, "wo_b": None,
        "w1": 1, "w2": 0, "w2_b": None, "w3": 1,
    }
    dec_layer = {
        "attn_norm": None, "ffn_norm": None,
        "wq": 1, "wk": 1, "wv": 1, "wo": 0,
        "w1": 1, "w2": 0, "w3": 1,
        "ada_down": None, "ada_up": None,
    }
    return {
        "encoder": {
            "conv0_w": None, "conv0_b": None, "conv1_w": None, "conv1_b": None,
            "layers": tuple(dict(enc_layer) for _ in range(cfg.encoder.layers)),
            "norm": None,
        },
        "adapter": {"w0": 1, "w1": 0},
        "decoder": {
            "embed": 0,
            "layers": tuple(dict(dec_layer) for _ in range(cfg.decoder.layers)),
            "norm": None,
        },
    }


def fleet_state_shard_dims(cfg: VoxtralConfig, kv_dtype: str = "float",
                           enc_kv_dtype: str | None = None):
    """The FleetState's layout (the JAX `fleet_state_pspecs`): each leaf a
    tuple of mesh axis names (or None) per tensor axis, () for replicated
    scalars. Rings [B, P, heads*hd] on ('data', None, 'model'), scale tables
    [B, heads, P] on ('data', 'model', None), per-stream tables on 'data'."""
    from voxtral_tpu_torch.models.decoder import DecodeState
    from voxtral_tpu_torch.models.encoder import EncoderState
    from voxtral_tpu_torch.runtime.fleet import FleetState
    ring, scale, row, rep = (DATA, None, MODEL), (DATA, MODEL, None), (DATA,), ()
    enc_l, dec_l = cfg.encoder.layers, cfg.decoder.layers
    int8 = kv_dtype in ("int8", "int4")
    enc_q = (enc_kv_dtype or kv_dtype) in ("int8", "int4")
    return FleetState(
        pcm_tail=row, mel_tail=row, conv0_tail=row,
        encoder=EncoderState(
            k_ring=(ring,) * enc_l, v_ring=(ring,) * enc_l,
            k_scale=(scale,) * enc_l if enc_q else None,
            v_scale=(scale,) * enc_l if enc_q else None,
            slot_pos=row, pending_k=(ring,) * enc_l, pending_v=(ring,) * enc_l,
            pending_ks=(scale,) * enc_l if enc_q else None,
            pending_vs=(scale,) * enc_l if enc_q else None,
            pending_sp=row, pending_adv=rep, write_ctr=rep, next_pos=row),
        decode=DecodeState(
            k_ring=(ring,) * dec_l, v_ring=(ring,) * dec_l,
            k_scale=(scale,) * dec_l if int8 else None,
            v_scale=(scale,) * dec_l if int8 else None,
            slot_pos=row, pending_k=(ring,) * dec_l, pending_v=(ring,) * dec_l,
            pending_sp=row, pending_adv=rep, write_ctr=rep,
            pos=row, prev_token=row, done=row),
    )


def _slice(t: torch.Tensor, axis: int, tp: TensorParallel) -> torch.Tensor:
    n = t.shape[axis]
    if n % tp.model_size:
        raise ValueError(f"axis {axis} of {tuple(t.shape)} is not divisible by the model "
                         f"axis {tp.model_size}")
    c = n // tp.model_size
    # a copy: a view would keep the whole tensor alive
    return t.narrow(axis, tp.model_rank * c, c).clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, cfg: VoxtralConfig, tp: TensorParallel) -> dict:
    """This rank's contiguous slices of a whole param tree (float or Q8
    leaves); replicated leaves are shared, not copied. On a model axis of
    one rank every leaf is whole, and the tree itself is returned."""
    if tp.model_size == 1:
        return params

    def put(x, axis):
        if axis is None:
            return x
        if isinstance(x, Quantized):
            scaled = 0 if x.axis == 0 else x.q.dim() - 1
            return Quantized(q=_slice(x.q, axis, tp),
                             s=_slice(x.s, 0, tp) if axis == scaled else x.s, axis=x.axis)
        return _slice(x, axis, tp)

    def walk(node, dims):
        if isinstance(node, dict):
            return {k: walk(v, dims[k]) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, d) for v, d in zip(node, dims))
        return put(node, dims)

    return walk(params, param_shard_dims(cfg))
