"""Weight I/O for the port: safetensors reader and writer, param-tree
mapping, random init.

Counterpart of `voxtral_tpu/weights.py`. The param tree has the JAX
package's layout, as plain dicts of torch tensors:
- linear weights are stored [in_features, out_features] (x @ w), the
  transpose of the safetensors [out, in] layout;
- "layers" is a tuple of per-layer dicts;
- norm weights, the conv stem, biases and the ada projections stay float32
  in every mode; conv weights are [K, C_in, C_out];
- a Q8 file's 2-D tensors load as `quant.Quantized` leaves: a transposed
  linear weight as (int8 [in, out], per-out scales), the embedding table as
  (int8 [vocab, dim], per-vocab-row scales, axis=0).

bf16 is handled by bit view (uint16 -> torch.bfloat16), so neither the
reader nor `from_numpy_params` needs ml_dtypes or a float round trip.
"""

from __future__ import annotations

import json
import struct
from typing import NamedTuple

import numpy as np
import torch

from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.utils import resolve_device

ENC_PREFIX = "mm_streams_embeddings.embedding_module.whisper_encoder"
ADA_PREFIX = "mm_streams_embeddings.embedding_module.audio_language_projection"
EMB_NAME = "mm_streams_embeddings.embedding_module.tok_embeddings.weight"

# safetensors dtype -> (numpy storage dtype, torch dtype); BF16 is read as
# uint16 and reinterpreted
_DTYPES = {
    "F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16), "I8": (np.int8, torch.int8),
    "I32": (np.int32, torch.int32), "I64": (np.int64, torch.int64),
    "F64": (np.float64, torch.float64), "U8": (np.uint8, torch.uint8),
}

# ---------------------------------------------------------------------------
# Safetensors file access
# ---------------------------------------------------------------------------

class SafetensorsFile:
    """Reader for a safetensors file, including the custom Q8 dtype
    (`q8_tensor`)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            raw8 = f.read(8)
            if len(raw8) < 8:
                raise ValueError(f"{path}: truncated safetensors header")
            (hlen,) = struct.unpack("<Q", raw8)
            hraw = f.read(hlen)
            if len(hraw) < hlen:
                raise ValueError(f"{path}: header length {hlen} exceeds file")
            header = json.loads(hraw)
        self.header = {k: v for k, v in header.items() if k != "__metadata__"}
        self.metadata = header.get("__metadata__", {})
        self._data_start = 8 + hlen
        # copy-on-write map: tensors are writable views (torch.from_numpy
        # needs that) and the file is never modified
        self._mmap = np.memmap(path, dtype=np.uint8, mode="c")
        self._validate_offsets()

    def _validate_offsets(self):
        """Reject truncated/corrupt files up front (the reference validates
        every tensor against the file size at open,
        voxtral_safetensors.c:272-282); the byte count is also checked
        against dtype x shape."""
        data_bytes = self._mmap.size - self._data_start
        for name, meta in self.header.items():
            s, e = meta["data_offsets"]
            if not (0 <= s <= e <= data_bytes):
                raise ValueError(
                    f"{self.path}: data out of bounds for {name}: "
                    f"offsets [{s}, {e}) vs {data_bytes} data bytes")
            shape = meta["shape"]
            n = 1
            for d in shape:
                if d < 0:
                    raise ValueError(
                        f"{self.path}: negative dim in shape of {name}")
                n *= d
            if meta["dtype"] == "Q8":
                if len(shape) != 2:
                    raise ValueError(f"{self.path}: Q8 tensor {name} must "
                                     f"be 2-D, got shape {shape}")
                want = 4 * shape[0] + n           # [rows f32 scales][int8]
            elif meta["dtype"] in _DTYPES:
                want = n * np.dtype(_DTYPES[meta["dtype"]][0]).itemsize
            else:
                raise ValueError(
                    f"{self.path}: unknown dtype {meta['dtype']!r} for {name}")
            if e - s != want:
                raise ValueError(
                    f"{self.path}: size mismatch for {name}: {e - s} bytes "
                    f"vs {want} expected for {meta['dtype']} {shape}")

    def names(self) -> list[str]:
        return list(self.header.keys())

    def info(self, name: str) -> dict:
        """The tensor's header entry: dtype, shape, data_offsets."""
        return self.header[name]

    def is_q8(self, name: str) -> bool:
        return self.header[name]["dtype"] == "Q8"

    def _raw(self, name: str) -> np.ndarray:
        s, e = self.header[name]["data_offsets"]
        return self._mmap[self._data_start + s:self._data_start + e]

    def tensor(self, name: str) -> torch.Tensor:
        """Host tensor viewing the mapped file (no copy). A Q8 tensor raises:
        read it with `q8_tensor`."""
        meta = self.header[name]
        if meta["dtype"] == "Q8":
            raise ValueError(f"{name} is Q8; use q8_tensor()")
        np_dt, torch_dt = _DTYPES[meta["dtype"]]
        t = torch.from_numpy(self._raw(name).view(np_dt).reshape(meta["shape"]))
        return t.view(torch_dt) if torch_dt == torch.bfloat16 else t

    def q8_tensor(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """A Q8 tensor as host views (scales f32 [rows], codes int8
        [rows, cols]) of its layout [rows f32 scales][rows*cols int8]."""
        rows, cols = self.header[name]["shape"]
        raw = self._raw(name)
        scales = torch.from_numpy(raw[:4 * rows].view(np.float32))
        q = torch.from_numpy(raw[4 * rows:].view(np.int8).reshape(rows, cols))
        return scales, q

    def tensor_f32(self, name: str) -> torch.Tensor:
        """A new f32 host tensor of the values (a Q8 tensor dequantized:
        codes times their row's scale)."""
        if self.is_q8(name):
            scales, q = self.q8_tensor(name)
            return q.float() * scales[:, None]
        return self.tensor(name).float()


# numpy storage dtype -> safetensors name, for the writer (bf16 is written
# from its uint16 bits, see _storage)
_NAMES = {np.dtype(np_dt): name for name, (np_dt, _) in _DTYPES.items() if name != "BF16"}


def _storage(arr) -> tuple[str, np.ndarray]:
    """(safetensors dtype name, contiguous numpy array of the stored bytes)
    of a numpy array; bf16 (an ml_dtypes array) is stored as its bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return "BF16", arr.view(np.uint16)
    if arr.dtype not in _NAMES:
        raise ValueError(f"dtype {arr.dtype} has no safetensors name here")
    return _NAMES[arr.dtype], arr


def save_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> None:
    """Write `tensors` (name -> numpy array, or the Q8 tuple
    ("Q8", scales, q, shape)) in the layout `SafetensorsFile` reads: a Q8
    tensor is [rows f32 scales][rows * cols int8]. The header is the JAX
    package's writer's (voxtral_tpu/weights.py:149-176), key for key."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        if isinstance(arr, tuple):
            _, scales, q, shape = arr
            blob = (np.asarray(scales, dtype=np.float32).tobytes()
                    + np.asarray(q, dtype=np.int8).tobytes())
            header[name] = {"dtype": "Q8", "shape": list(shape),
                            "data_offsets": [offset, offset + len(blob)]}
        else:
            dtype, data = _storage(arr)
            blob = data.tobytes()
            header[name] = {"dtype": dtype, "shape": list(data.shape),
                            "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)


# ---------------------------------------------------------------------------
# Name schema
# ---------------------------------------------------------------------------

def encoder_layer_names(i: int) -> dict[str, tuple[str, bool]]:
    """tree key -> (tensor name, transpose?) for encoder layer i."""
    lp = f"{ENC_PREFIX}.transformer.layers.{i}"
    return {
        "attn_norm": (f"{lp}.attention_norm.weight", False),
        "wq": (f"{lp}.attention.wq.weight", True),
        "wq_b": (f"{lp}.attention.wq.bias", False),
        "wk": (f"{lp}.attention.wk.weight", True),
        "wv": (f"{lp}.attention.wv.weight", True),
        "wv_b": (f"{lp}.attention.wv.bias", False),
        "wo": (f"{lp}.attention.wo.weight", True),
        "wo_b": (f"{lp}.attention.wo.bias", False),
        "ffn_norm": (f"{lp}.ffn_norm.weight", False),
        "w1": (f"{lp}.feed_forward.w1.weight", True),
        "w2": (f"{lp}.feed_forward.w2.weight", True),
        "w2_b": (f"{lp}.feed_forward.w2.bias", False),
        "w3": (f"{lp}.feed_forward.w3.weight", True),
    }


def decoder_layer_names(i: int) -> dict[str, tuple[str, bool]]:
    lp = f"layers.{i}"
    return {
        "attn_norm": (f"{lp}.attention_norm.weight", False),
        "wq": (f"{lp}.attention.wq.weight", True),
        "wk": (f"{lp}.attention.wk.weight", True),
        "wv": (f"{lp}.attention.wv.weight", True),
        "wo": (f"{lp}.attention.wo.weight", True),
        "ffn_norm": (f"{lp}.ffn_norm.weight", False),
        "w1": (f"{lp}.feed_forward.w1.weight", True),
        "w2": (f"{lp}.feed_forward.w2.weight", True),
        "w3": (f"{lp}.feed_forward.w3.weight", True),
        "ada_down": (f"{lp}.ada_rms_norm_t_cond.0.weight", True),
        "ada_up": (f"{lp}.ada_rms_norm_t_cond.2.weight", True),
    }


# Tree keys that stay f32 regardless of param_dtype
_F32_KEYS = {"attn_norm", "ffn_norm", "wq_b", "wv_b", "wo_b", "w2_b",
             "ada_down", "ada_up"}


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_params(path: str, cfg: VoxtralConfig, *, device="cuda") -> dict:
    """Load the full Voxtral param tree from a consolidated safetensors file
    onto `device`. Each tensor is copied to the device in its stored dtype,
    then transposed and cast there; a Q8 tensor becomes a `Quantized` leaf
    (codes transposed for a linear weight, scales on the out axis; the
    untransposed embedding table keeps per-row scales, axis=0)."""
    dev = resolve_device(device)
    sf = SafetensorsFile(path)

    def get(name, transpose, dtype):
        if sf.is_q8(name):
            s, q = (t.to(dev, copy=True) for t in sf.q8_tensor(name))
            if transpose:
                return Quantized(q.t().contiguous(), s)
            return Quantized(q, s, axis=0)
        t = sf.tensor(name).to(dev, copy=True)   # never alias the map
        if transpose:
            t = t.t()
        return t.to(dtype).contiguous()

    def layer_list(layer_names_fn, n_layers):
        return tuple(
            {key: get(name, transpose,
                      torch.float32 if key in _F32_KEYS else cfg.param_dtype)
             for key, (name, transpose) in layer_names_fn(i).items()}
            for i in range(n_layers))

    def f32(name):
        return get(name, False, torch.float32)

    def conv_w(name):
        # stored [O, I, K]; the tree keeps the JAX package's [K, I, O]
        return f32(name).permute(2, 1, 0).contiguous()

    return {
        "encoder": {
            "conv0_w": conv_w(f"{ENC_PREFIX}.conv_layers.0.conv.weight"),
            "conv0_b": f32(f"{ENC_PREFIX}.conv_layers.0.conv.bias"),
            "conv1_w": conv_w(f"{ENC_PREFIX}.conv_layers.1.conv.weight"),
            "conv1_b": f32(f"{ENC_PREFIX}.conv_layers.1.conv.bias"),
            "layers": layer_list(encoder_layer_names, cfg.encoder.layers),
            "norm": f32(f"{ENC_PREFIX}.transformer.norm.weight"),
        },
        "adapter": {
            "w0": get(f"{ADA_PREFIX}.0.weight", True, cfg.param_dtype),
            "w1": get(f"{ADA_PREFIX}.2.weight", True, cfg.param_dtype),
        },
        "decoder": {
            "embed": get(EMB_NAME, False, cfg.param_dtype),
            "layers": layer_list(decoder_layer_names, cfg.decoder.layers),
            "norm": f32("norm.weight"),
        },
    }


def _numpy_to_torch(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:           # e.g. a read-only view of a jax array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":      # ml_dtypes leaf: reinterpret bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_numpy_params(tree, device="cuda"):
    """A numpy param tree (e.g. the JAX package's
    `random_params(cfg, seed, numpy_out=True)`) as the port's tree on
    `device`, bit for bit. Leaves that carry `.q`, `.s` and `.axis` (the
    JAX package's Q8 leaves) become `Quantized` leaves."""
    dev = resolve_device(device)

    def walk(node):
        if all(hasattr(node, a) for a in ("q", "s", "axis")):
            return Quantized(walk(node.q), walk(node.s), node.axis)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        return _numpy_to_torch(node).to(dev)

    return walk(tree)


def params_to_safetensors(params: dict, cfg: VoxtralConfig, path: str) -> None:
    """Write a float param tree (the port's torch tensors on any device, or
    numpy arrays) back to reference-layout safetensors, every tensor f32:
    conv weights [K, I, O] -> [O, I, K], linear weights transposed. The
    same file as `voxtral_tpu/weights.py:params_to_safetensors` writes for
    the same values."""
    t: dict[str, np.ndarray] = {}
    enc, dec, ada = params["encoder"], params["decoder"], params["adapter"]

    def f32(arr) -> np.ndarray:
        if isinstance(arr, Quantized):
            raise TypeError("params_to_safetensors writes float trees; dequantize Q8 leaves")
        if isinstance(arr, torch.Tensor):
            return arr.detach().to("cpu", torch.float32).numpy()
        return np.asarray(arr, dtype=np.float32)

    def put(name, arr, transpose):
        a = f32(arr)
        t[name] = a.T if transpose else a

    def put_conv(name, arr):
        t[name] = f32(arr).transpose(2, 1, 0)            # [K, I, O] -> [O, I, K]

    put_conv(f"{ENC_PREFIX}.conv_layers.0.conv.weight", enc["conv0_w"])
    put(f"{ENC_PREFIX}.conv_layers.0.conv.bias", enc["conv0_b"], False)
    put_conv(f"{ENC_PREFIX}.conv_layers.1.conv.weight", enc["conv1_w"])
    put(f"{ENC_PREFIX}.conv_layers.1.conv.bias", enc["conv1_b"], False)
    for i in range(cfg.encoder.layers):
        for key, (name, transpose) in encoder_layer_names(i).items():
            put(name, enc["layers"][i][key], transpose)
    put(f"{ENC_PREFIX}.transformer.norm.weight", enc["norm"], False)
    put(f"{ADA_PREFIX}.0.weight", ada["w0"], True)
    put(f"{ADA_PREFIX}.2.weight", ada["w1"], True)
    put(EMB_NAME, dec["embed"], False)
    for i in range(cfg.decoder.layers):
        for key, (name, transpose) in decoder_layer_names(i).items():
            put(name, dec["layers"][i][key], transpose)
    put("norm.weight", dec["norm"], False)
    save_safetensors(path, t)


# ---------------------------------------------------------------------------
# Random init (synthetic runs; value-independent performance)
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def param_shapes(cfg: VoxtralConfig) -> dict:
    """Tree of Leaf(shape, dtype) describing the param tree."""
    e, d = cfg.encoder, cfg.decoder
    pd, f32 = cfg.param_dtype, torch.float32
    L, D, A, H = e.layers, e.dim, e.attn_dim, e.hidden
    Ld, Dd, Qd, Kd, Hd = d.layers, d.dim, d.q_dim, d.kv_dim, d.hidden
    enc_layer = {
        "attn_norm": Leaf((D,), f32), "ffn_norm": Leaf((D,), f32),
        "wq": Leaf((D, A), pd), "wq_b": Leaf((A,), f32),
        "wk": Leaf((D, A), pd),
        "wv": Leaf((D, A), pd), "wv_b": Leaf((A,), f32),
        "wo": Leaf((A, D), pd), "wo_b": Leaf((D,), f32),
        "w1": Leaf((D, H), pd), "w2": Leaf((H, D), pd),
        "w2_b": Leaf((D,), f32), "w3": Leaf((D, H), pd),
    }
    dec_layer = {
        "attn_norm": Leaf((Dd,), f32), "ffn_norm": Leaf((Dd,), f32),
        "wq": Leaf((Dd, Qd), pd), "wk": Leaf((Dd, Kd), pd),
        "wv": Leaf((Dd, Kd), pd), "wo": Leaf((Qd, Dd), pd),
        "w1": Leaf((Dd, Hd), pd), "w2": Leaf((Hd, Dd), pd),
        "w3": Leaf((Dd, Hd), pd),
        "ada_down": Leaf((Dd, d.ada_dim), f32),
        "ada_up": Leaf((d.ada_dim, Dd), f32),
    }
    return {
        "encoder": {
            "conv0_w": Leaf((e.conv_kernel, cfg.audio.mel_bins, D), f32),
            "conv0_b": Leaf((D,), f32),
            "conv1_w": Leaf((e.conv_kernel, D, D), f32), "conv1_b": Leaf((D,), f32),
            "layers": tuple(dict(enc_layer) for _ in range(L)),
            "norm": Leaf((D,), f32),
        },
        "adapter": {"w0": Leaf((cfg.adapter_in, cfg.adapter_hidden), pd),
                    "w1": Leaf((cfg.adapter_hidden, Dd), pd)},
        "decoder": {
            "embed": Leaf((d.vocab_size, Dd), pd),
            "layers": tuple(dict(dec_layer) for _ in range(Ld)),
            "norm": Leaf((Dd,), f32),
        },
    }


_NORM_KEYS = ("attn_norm", "ffn_norm", "norm")


def random_params(cfg: VoxtralConfig, seed: int = 0, scale: float = 0.02,
                  device="cuda") -> dict:
    """Random param tree generated on `device` from a torch.Generator (no
    host materialisation; the counterpart of the JAX package's
    `random_params_device`). Leaves are N(0, scale) drawn in f32 and cast
    to their dtype; norm weights are 1 + N(0, scale). The numbers differ
    from the JAX package's generators: tests feed both packages one numpy
    tree through `from_numpy_params` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if not isinstance(node, Leaf):
            return tuple(walk(v) for v in node)
        t = torch.randn(node.shape, generator=gen, device=dev,
                        dtype=torch.float32) * scale
        if key in _NORM_KEYS:
            t += 1.0
        return t.to(node.dtype)

    return walk(param_shapes(cfg))


def random_params_host(cfg: VoxtralConfig, seed: int = 0, scale: float = 0.02,
                       device="cuda") -> dict:
    """The JAX package's host random tree (`random_params` in
    voxtral_tpu/weights.py): the same numpy RandomState draws in the same
    order, each f32 draw cast to its leaf's dtype (round to nearest even,
    as jnp.asarray does), moved to `device`. Norm weights are
    1 + N(0, scale), every other leaf N(0, scale). Drawn on the host, so it
    is meant for small configurations (`tiny_config`); full-width random
    weights come from `random_params`."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def draw(node, key=None):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        if not isinstance(node, Leaf):
            return tuple(draw(v) for v in node)
        t = torch.from_numpy((rng.randn(*node.shape) * scale).astype(np.float32))
        if key in _NORM_KEYS:
            t = 1.0 + t
        return t.to(dev, node.dtype)

    shapes = param_shapes(cfg)
    # the JAX tree draws both layer stacks first, then the other leaves in
    # tree order
    layers = {part: draw(shapes[part]["layers"]) for part in ("encoder", "decoder")}
    return {part: {k: layers[part] if k == "layers" else draw(v, k)
                   for k, v in node.items()}
            for part, node in shapes.items()}
