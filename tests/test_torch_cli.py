"""The port's command line and top-level API (voxtral_tpu_torch.cli,
voxtral_tpu_torch.load / transcribe / transcribe_audio) against the JAX
package's, on the CPU.

`python -m voxtral_tpu_torch.cli --cpu --parity --tiny --random-init 7`
must print exactly the bytes `python -m voxtral_tpu.cli` prints with the
same flags (the same seeded weights through weights.random_params_host),
for a WAV file, the same WAV on --stdin, --alt and --batch. Both CLIs run
as subprocesses, all started together, with the mel pinned to numpy
(VOX_NATIVE=0). Without --cpu, a machine with no CUDA makes the port's CLI
fail."""

import os
import struct
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxtral_tpu
import voxtral_tpu_torch
from test_torch_stream import _lively
from voxtral_tpu.config import tiny_config as jax_tiny_config
from voxtral_tpu.tokenizer import Tokenizer as JaxTokenizer
from voxtral_tpu.tokenizer import make_test_tokenizer_json
from voxtral_tpu.weights import random_params as jax_random_params
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.quant import Quantized
from voxtral_tpu_torch.tokenizer import Tokenizer
from voxtral_tpu_torch.weights import from_numpy_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--cpu", "--parity", "--tiny", "--random-init", "7", "--silent"]
CASES = {"file": ["-i", "{wav}", "-I", "1.0"],
         "stdin": ["--stdin", "-I", "1.0"],
         "alt": ["-i", "{wav}", "-I", "1.0", "--alt", "0.99"],
         "batch": ["-i", "{wav}", "--batch"]}


def _wav_bytes(samples: np.ndarray, rate=16000) -> bytes:
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    return hdr + pcm


@pytest.fixture(scope="module")
def noise_wav(tmp_path_factory):
    """2 s of noise: with seed-7 weights in f32 it decodes text tokens
    (tests/test_cli.py)."""
    rng = np.random.RandomState(21)
    data = _wav_bytes((rng.randn(2 * 16000) * 0.3).astype(np.float32))
    p = tmp_path_factory.mktemp("cli") / "noise.wav"
    p.write_bytes(data)
    return str(p), data


def _cli(module, args, stdin_data=None, cpu=True):
    env = {**os.environ, "VOX_NATIVE": "0", "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, "-m", module] + (FLAGS if cpu else FLAGS[1:]) + args
    return subprocess.run(cmd, cwd=ROOT, input=stdin_data, capture_output=True,
                          timeout=600, env=env)


@pytest.fixture(scope="module")
def runs(noise_wav, tmp_path_factory):
    """{(package, case): CompletedProcess}, every run started together; the
    port's file case also runs once more under --profile."""
    path, data = noise_wav
    prof = str(tmp_path_factory.mktemp("prof") / "trace")
    jobs = {}
    for pkg in ("voxtral_tpu.cli", "voxtral_tpu_torch.cli"):
        for case, args in CASES.items():
            jobs[(pkg, case)] = ([a.format(wav=path) for a in args],
                                 data if case == "stdin" else None)
    jobs[("voxtral_tpu_torch.cli", "profile")] = (
        ["-i", path, "-I", "1.0", "--profile", prof], None)
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(_cli, k[0], args, stdin) for k, (args, stdin) in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    out["profile_dir"] = prof
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_cli_stdout_equals_jax_cli(runs, case):
    want, got = runs[("voxtral_tpu.cli", case)], runs[("voxtral_tpu_torch.cli", case)]
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout.decode().strip(), "no transcript on stdout"
    assert got.stdout == want.stdout


def test_cli_stdin_equals_file(runs):
    """--stdin sniffs and skips the RIFF header (main.c:304-340)."""
    port = "voxtral_tpu_torch.cli"
    assert runs[(port, "stdin")].stdout == runs[(port, "file")].stdout


def test_cli_profile_writes_trace(runs):
    r = runs[("voxtral_tpu_torch.cli", "profile")]
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == runs[("voxtral_tpu_torch.cli", "file")].stdout
    assert os.path.getsize(os.path.join(runs["profile_dir"], "trace.json")) > 0


def test_cli_without_cpu_needs_cuda(noise_wav):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    r = _cli("voxtral_tpu_torch.cli", ["-i", noise_wav[0]], cpu=False)
    assert r.returncode != 0 and b"CUDA is not available" in r.stderr
    assert r.stdout == b""


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) on the lively tiny weights with the test
    tokenizer, so the transcript has text."""
    tok = str(tmp_path_factory.mktemp("tok") / "tekken.json")
    make_test_tokenizer_json(tok, vocab_size=256)
    live = _lively(jax_random_params(tiny_config(), 1234, numpy_out=True))
    return ((jax.tree.map(jnp.asarray, live), jax_tiny_config(), JaxTokenizer(tok)),
            (from_numpy_params(live, "cpu"), tiny_config(), Tokenizer(tok)))


def test_transcribe_matches_jax(engines, noise_wav, monkeypatch):
    monkeypatch.setenv("VOX_NATIVE", "0")
    jax_eng, port_eng = engines
    audio = np.random.RandomState(5).randn(3 * 16000).astype(np.float32) * 0.3
    kw = dict(interval=1.0, delay_ms=960)
    want = voxtral_tpu.transcribe_audio(jax_eng, audio, **kw)
    got = voxtral_tpu_torch.transcribe_audio(port_eng, audio, device="cpu", **kw)
    assert got == want and got
    path = noise_wav[0]
    assert voxtral_tpu_torch.transcribe(port_eng, path, device="cpu") \
        == voxtral_tpu.transcribe(jax_eng, path)
    with pytest.raises(RuntimeError, match="CUDA is not available|params live on"):
        voxtral_tpu_torch.transcribe_audio(port_eng, audio)


def test_load_returns_tokenizer_when_present(tmp_path, monkeypatch):
    """load() -> (params, cfg, tokenizer): the tokenizer of tekken.json, or
    None; quantize=True gives Q8 leaves. The 4B file is stood in for by a
    tiny tree (no weights in the repo)."""
    import voxtral_tpu_torch.weights as W
    calls = []

    def fake_load_params(path, cfg, *, device="cuda"):
        calls.append((path, cfg.decoder.dim, device))
        return W.random_params_host(tiny_config(), 0, device=device)

    monkeypatch.setattr(W, "load_params", fake_load_params)
    params, cfg, tok = voxtral_tpu_torch.load(str(tmp_path), device="cpu")
    assert tok is None and cfg.compute_dtype == torch.bfloat16
    assert calls[-1] == (str(tmp_path / "consolidated.safetensors"), 3072, "cpu")
    make_test_tokenizer_json(str(tmp_path / "tekken.json"))
    params, cfg, tok = voxtral_tpu_torch.load(str(tmp_path), quantize=True,
                                              dtype=torch.float32, device="cpu")
    assert isinstance(tok, Tokenizer) and tok.vocab_size == 356
    assert cfg.compute_dtype == torch.float32
    assert isinstance(params["decoder"]["layers"][0]["wq"], Quantized)
