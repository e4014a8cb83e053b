"""The port's tools (voxtral_tpu_torch.tools) against the repo's JAX-side
tools: the quantizer writes the same tensors, byte for byte, and the same
header but for its producer; the inspector prints the same lines; each
profile tool runs at a tiny size on the CPU and returns its numbers, and
refuses the default device without CUDA."""

import json
import shutil
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from tools import inspect_weights as jax_inspect
from tools import quantize as jax_quantize
from voxtral_tpu.config import tiny_config as jax_tiny_config
from voxtral_tpu.weights import SafetensorsFile as JaxSafetensorsFile
from voxtral_tpu.weights import params_to_safetensors
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.ops import read_ceiling
from voxtral_tpu_torch.tools import inspect_weights, quantize
from voxtral_tpu_torch.tools.profile_attn_layout import profile_attn_layout
from voxtral_tpu_torch.tools.profile_colsum_split import profile_colsum_split
from voxtral_tpu_torch.tools.profile_dma_ceiling import profile_dma_ceiling
from voxtral_tpu_torch.tools.profile_int4_unpack import profile_int4_unpack
from voxtral_tpu_torch.tools.profile_q8_matmul_roofline import profile_q8_matmul_roofline
from voxtral_tpu_torch.tools.profile_weight_stream import profile_weight_stream
from voxtral_tpu_torch.weights import SafetensorsFile, save_safetensors

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    """A tiny_config() params file written by the JAX package."""
    path = str(tmp_path_factory.mktemp("params") / "consolidated.safetensors")
    cfg = jax_tiny_config()
    params_to_safetensors(jax_random_params(cfg, 1234, numpy_out=True), cfg, path)
    return path


def _read(path):
    """(header dict, data bytes) of a safetensors file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        return header, f.read()


def _assert_same_but_producer(path_jax, path_port):
    hj, dj = _read(path_jax)
    hp, dp = _read(path_port)
    meta_j, meta_p = hj.pop("__metadata__"), hp.pop("__metadata__")
    assert meta_j.pop("producer") == "voxtral_tpu"
    assert meta_p.pop("producer") == "voxtral_tpu_torch"
    assert meta_j == meta_p == {"quantization": "Q8"}
    assert list(hj) == list(hp) and hj == hp
    for name, meta in hj.items():
        s, e = meta["data_offsets"]
        assert dj[s:e] == dp[s:e], name
    assert dj == dp


def test_quantize_writes_the_jax_tools_bytes(tmp_path, params_file):
    """Quantize the same file with both tools, then the quantized file again
    (Q8 tensors pass through): every tensor's name, dtype, shape and bytes
    agree; the headers differ only in `producer`."""
    a, b = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_quantize.quantize_file(params_file, a, verbose=False)
    quantize.quantize_file(params_file, b, verbose=False)
    _assert_same_but_producer(a, b)
    header, _ = _read(b)
    dtypes = {meta["dtype"] for name, meta in header.items() if name != "__metadata__"}
    assert dtypes == {"Q8", "F32"}
    a2, b2 = str(tmp_path / "jax2.safetensors"), str(tmp_path / "port2.safetensors")
    jax_quantize.quantize_file(a, a2, verbose=False)
    quantize.quantize_file(b, b2, verbose=False)
    _assert_same_but_producer(a2, b2)
    assert _read(b2)[1] == _read(b)[1]


def test_quantize_main_copies_the_side_files(tmp_path, params_file, capsys):
    src = tmp_path / "model"
    src.mkdir()
    shutil.copy(params_file, src / "consolidated.safetensors")
    (src / "params.json").write_text('{"dim": 64}')
    assert quantize.main([str(src)]) == 2                   # usage
    assert quantize.main([str(src), str(tmp_path / "q8")]) == 0
    assert "tensors -> Q8" in capsys.readouterr().out
    assert (tmp_path / "q8" / "params.json").read_text() == '{"dim": 64}'
    assert not (tmp_path / "q8" / "tekken.json").exists()
    assert jax_quantize.main([str(src), str(tmp_path / "q8_jax")]) == 0
    _assert_same_but_producer(str(tmp_path / "q8_jax" / "consolidated.safetensors"),
                              str(tmp_path / "q8" / "consolidated.safetensors"))


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("args", [[], ["--summary"], ["--prefix", "layers.0"],
                                  ["--summary", "--prefix", "mm_streams"]])
def test_inspect_prints_the_jax_tools_lines(tmp_path, params_file, capsys, q8, args):
    path = params_file
    if q8:
        path = str(tmp_path / "q8.safetensors")
        jax_quantize.quantize_file(params_file, path, verbose=False)
    assert jax_inspect.main([path, *args]) == 0
    want = capsys.readouterr().out
    assert inspect_weights.main([path, *args]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 2


def test_writer_and_reader_agree_with_the_jax_package(tmp_path):
    """The port's writer is read back by the JAX reader (and the port's),
    bf16 as its bits; Q8 tensors dequantize to the same f32 values."""
    rng = np.random.RandomState(4)
    f32 = rng.randn(3, 5).astype(np.float32)
    bf = rng.randn(4, 6).astype(ml_dtypes.bfloat16)
    q = rng.randint(-127, 128, size=(4, 7)).astype(np.int8)
    s = (rng.rand(4) + 0.5).astype(np.float32)
    path = str(tmp_path / "w.safetensors")
    save_safetensors(path, {"f32": f32, "bf16": bf, "i8": q, "q8": ("Q8", s, q, q.shape)},
                     metadata={"k": "v"})
    js, ps = JaxSafetensorsFile(path), SafetensorsFile(path)
    assert js.names() == ps.names() == ["f32", "bf16", "i8", "q8"]
    assert js.metadata == ps.metadata == {"k": "v"}
    for name in js.names():
        assert js.info(name) == ps.info(name)
        np.testing.assert_array_equal(ps.tensor_f32(name).numpy(), js.tensor_f32(name))
    np.testing.assert_array_equal(js.tensor("bf16").view(np.uint16), bf.view(np.uint16))
    assert ps.tensor("bf16").dtype == torch.bfloat16 and ps.tensor("i8").dtype == torch.int8
    with pytest.raises(ValueError, match="safetensors name"):
        save_safetensors(path, {"u16": np.zeros(3, np.uint16)})


def test_profile_tools_run_on_the_cpu_at_a_tiny_size():
    dims = dict(layers=2, dim=64, q_dim=64, kv_dim=16, hidden=128, iters=2, device="cpu")
    roof = profile_q8_matmul_roofline(3, vocab=256, **dims)
    stream = profile_weight_stream(8, 128, **dims)
    dma = profile_dma_ceiling(2, slots=40, kv_dim=64, layers=3, iters=2, device="cpu")
    layer_bytes = 64 * (64 + 2 * 16) + 64 * 64 + 3 * 64 * 128
    assert roof["read_bytes"] == roof["stack_bytes"] == 2 * layer_bytes
    assert roof["logits_bytes"] == 256 * 64
    assert stream["bytes"] == 2 * 2 * layer_bytes
    assert dma["bytes"] == 3 * 2 * 2 * 40 * 64 and dma["pairs"] == 3
    for res, keys in ((roof, ("stack", "read", "logits")),
                      (stream, ("matmul", "stream", "t3")), (dma, ("",))):
        assert res["device"] == "cpu" and res["power_limit"] is None
        for key in keys:
            pre = f"{key}_" if key else ""
            assert res[f"{pre}ms"] > 0 and res[f"{pre}gbps"] > 0


def test_colsum_split_sweep_runs_on_the_cpu_and_keeps_the_target():
    committed = read_ceiling._BLOCKS_PER_SM
    res = profile_colsum_split((1, 4), 2, layers=2, dim=64, q_dim=64, kv_dim=16, hidden=128,
                               streams=2, slots=40, iters=2, device="cpu")
    assert read_ceiling._BLOCKS_PER_SM == res["committed"] == committed
    assert res["t1_bytes"] == 2 * (64 * (64 + 2 * 16) + 64 * 64 + 3 * 64 * 128)
    assert res["t11_bytes"] == 2 * 2 * 2 * 40 * 16
    assert res["device"] == "cpu" and res["repeats"] == 2
    for c in ("t1", "t11"):
        for t in (1, 4):
            assert res[f"{c}_ms_{t}"] > 0 and res[f"{c}_gbps_{t}"] > 0


def test_layout_tools_run_on_the_cpu_at_a_tiny_size():
    """The tools' byte counts: the rings a pass reads (int4 unpack: gb8 and
    gb8 / 2), rings plus scales (layout; sp not counted)."""
    unpack = profile_int4_unpack(2, slots=40, kv_dim=256, layers=3, iters=2, device="cpu")
    layout = profile_attn_layout(2, slots=40, kv_heads=2, blks=(128, 256), layers=3, iters=2,
                                 device="cpu")
    assert unpack["bytes8"] == 3 * 2 * 2 * 40 * 256 == 2 * unpack["bytes4"]
    assert layout["bytes"] == 3 * (2 * 2 * 40 * 256 + 2 * 2 * 2 * 40 * 4)
    assert unpack["check_err"] <= unpack["check_tol"]
    assert unpack["t5_over_t4"] == unpack["t5_ms"] / unpack["t4_ms"]
    for res, pairs in ((unpack, [("t4_ms", "t4_gbps"), ("t5_ms", "t5_gbps")]),
                       (layout, [(f"t{t}_ms_{b}", f"t{t}_gbps_{b}")
                                 for b in (128, 256) for t in (6, 7)])):
        assert res["device"] == "cpu" and res["power_limit"] is None
        for ms, rate in pairs:
            assert res[ms] > 0 and res[rate] > 0
    assert layout["t7_over_t6_256"] == layout["t7_ms_256"] / layout["t6_ms_256"]


@pytest.mark.parametrize("tool", [profile_q8_matmul_roofline, profile_weight_stream,
                                  profile_dma_ceiling, profile_colsum_split,
                                  profile_int4_unpack, profile_attn_layout])
def test_profile_tools_default_to_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool()



def test_fleet_step_profile_groups_and_drive(monkeypatch):
    """profile_fleet_step (the phase-5 step's device time by kernel group,
    also chip_smoke.py's grouping): each kernel name lands in one group, the
    port's kernels and cuBLAS's before torch's generic ones; the drive runs
    at tiny_config on the CPU in both modes (a CPU profile has no kernel
    rows); `main` refuses without CUDA."""
    from voxtral_tpu_torch.config import tiny_config
    from voxtral_tpu_torch.models.decoder import ada_scales, time_conditioning
    from voxtral_tpu_torch.quant import quantize_params
    from voxtral_tpu_torch.tools import profile_fleet_step as pfs
    from voxtral_tpu_torch.weights import random_params
    rows = [(5.0, 2, "void splitKreduce_kernel<32, 16>"),
            (7.0, 3, "at::native::reduce_kernel<512>"),
            (3.0, 1, "at::native::vectorized_elementwise_kernel<4, AddFunctor>"),
            (2.0, 4, "rms_norm_kernel<float, float, 4, 2, true, true>"),
            (1.0, 1, "nvjet_tst_64x8"), (1.5, 2, "w8a16_mma_kernel<1, 2>"),
            (0.5, 1, "ring_dec_merge_kernel"), (0.25, 1, "ring_enc_mma_kernel"), (4.0, 1, "x")]
    g = pfs.kernel_groups(rows)
    assert g["cublas"] == (6.0, 3) and g["reduce"] == (7.0, 3) and g["elementwise"] == (3.0, 1)
    assert g["k4"] == (2.0, 4) and g["k2"] == (1.5, 2) and g["other"] == (4.0, 1)
    assert g["ring_dec"] == (0.5, 1) and g["ring_enc"] == (0.25, 1)
    assert g["all"] == (sum(r[0] for r in rows), sum(r[1] for r in rows))
    cfg = tiny_config()
    monkeypatch.setattr(pfs, "ENC_RING", 200)
    monkeypatch.setattr(pfs, "DEC_RING", 256)
    monkeypatch.setattr(pfs, "WARM", 1)
    params = random_params(cfg, seed=0, device="cpu")
    t_ada = ada_scales(params["decoder"], time_conditioning(
        cfg.streaming.delay_tokens, cfg.decoder.dim, device="cpu"))
    streams = torch.from_numpy(pfs.fleet_streams(
        cfg, [pfs.synthetic_audio(6.0, 200 + i) for i in range(2)]))
    for mode in pfs.PROFILED:
        if mode.startswith("q8"):
            params = quantize_params(params)
        r = pfs.profile_mode(params, cfg, t_ada, streams, mode)
        assert r["mode"] == mode and r["streams"] == 2 and r["step_wall_ms"] > 0
        assert r["launches"] == 0 and r["groups"]["all"] == dict(ms=0.0, launches=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            pfs.main()
