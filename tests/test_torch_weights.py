"""The port's weight I/O (voxtral_tpu_torch.weights) against files and trees
written by the JAX package, its device rules, and its independence from
jax."""

import os
import re
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from voxtral_tpu.config import tiny_config as jax_tiny_config
from voxtral_tpu.weights import params_to_safetensors, save_safetensors
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.utils import resolve_device
from voxtral_tpu_torch.weights import (
    SafetensorsFile, from_numpy_params, load_params, param_shapes, random_params,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "voxtral_tpu_torch")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("bf16", [False, True])
def test_safetensors_roundtrip_is_bit_identical(tmp_path, bf16):
    """JAX writes reference-layout safetensors; the port reads it back into
    exactly the tree `from_numpy_params` makes of the same numpy params."""
    jcfg = jax_tiny_config()
    cfg = tiny_config()
    if bf16:
        import jax.numpy as jnp
        jcfg = jcfg.with_dtype(jnp.bfloat16)
        cfg = cfg.with_dtype(torch.bfloat16)
    tree = jax_random_params(jcfg, 1234, numpy_out=True)
    path = os.path.join(tmp_path, "model.safetensors")
    params_to_safetensors(tree, jcfg, path)
    loaded = dict(_leaves(load_params(path, cfg, device="cpu")))
    direct = dict(_leaves(from_numpy_params(tree, "cpu")))
    assert loaded.keys() == direct.keys()
    for name, t in direct.items():
        assert loaded[name].dtype == t.dtype, name
        assert torch.equal(_bits(loaded[name]), _bits(t)), name
    assert direct[".decoder.embed"].dtype == (torch.bfloat16 if bf16 else torch.float32)


def test_from_numpy_params_keeps_bf16_bits():
    arr = (np.random.RandomState(0).randn(5, 7) * 3).astype(ml_dtypes.bfloat16)
    t = from_numpy_params({"w": arr}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), arr.view(np.int16))


def test_q8_tensors_raise_not_implemented(tmp_path):
    path = os.path.join(tmp_path, "q8.safetensors")
    q = np.arange(12, dtype=np.int8).reshape(3, 4)
    save_safetensors(path, {"w": ("Q8", np.ones(3, np.float32), q, (3, 4)),
                            "b": np.ones(4, np.float32)})
    sf = SafetensorsFile(path)
    assert sf.is_q8("w") and not sf.is_q8("b")
    torch.testing.assert_close(sf.tensor("b"), torch.ones(4))
    # as the JAX package: `tensor` refuses a Q8 name and points to q8_tensor
    with pytest.raises(ValueError, match="q8_tensor"):
        sf.tensor("w")
    scales, codes = sf.q8_tensor("w")
    assert torch.equal(scales, torch.ones(3)) and torch.equal(codes, torch.from_numpy(q))


def test_truncated_file_is_rejected(tmp_path):
    path = os.path.join(tmp_path, "t.safetensors")
    save_safetensors(path, {"a": np.ones((4, 4), np.float32)})
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError, match="out of bounds"):
        SafetensorsFile(path)


def test_random_params_layout_and_seed():
    cfg = tiny_config().with_dtype(torch.bfloat16)
    a = random_params(cfg, seed=3, device="cpu")
    b = random_params(cfg, seed=3, device="cpu")
    c = random_params(cfg, seed=4, device="cpu")
    shapes = dict(_leaves(param_shapes(cfg)))
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert len(la) == len(list(_leaves(
        jax_random_params(jax_tiny_config(), 0, numpy_out=True))))
    for name, t in la.items():
        leaf = shapes[name]
        assert tuple(t.shape) == tuple(leaf.shape) and t.dtype == leaf.dtype, name
        assert torch.equal(_bits(t), _bits(lb[name])), name
    assert not torch.equal(a["decoder"]["embed"], c["decoder"]["embed"])
    assert abs(a["decoder"]["norm"].mean().item() - 1.0) < 0.05
    assert a["encoder"]["layers"][0]["attn_norm"].dtype == torch.float32


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_params(tiny_config(), device="cuda")
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_without_jax():
    """Every module of the port imports in a process where jax cannot be
    imported, and none imports the JAX package or the repo's `tools`."""
    mods = sorted(
        "voxtral_tpu_torch." + os.path.relpath(os.path.join(d, f), PORT)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for d, _, files in os.walk(PORT) for f in files if f.endswith(".py"))
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib, voxtral_tpu_torch\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k in ('jax', 'voxtral_tpu', 'tools')\n"
            "               or k.startswith(('jax.', 'voxtral_tpu.', 'tools.'))\n"
            "               for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(r"voxtral_tpu\.|^\s*(import|from)\s+(jax|tools)\b", re.M)
    offenders = []
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(d, f)) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.join(d, f))
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        if pattern.search(fh.read()):
            offenders.append("chip_smoke.py")
    assert offenders == []
