"""The port's host audio surface (voxtral_tpu_torch.audio) against the JAX
package's: the incremental MelStream, WAV parsing/resampling/loading, the
native C++ binding (built into build/native/, never into native/) and the
microphone layer's capture commands and live loop. All host numpy code:
the same inputs must give the same bits (the native mel within 2e-4 of
numpy, as tests/test_native_audio.py holds the JAX binding)."""

import os
import struct

import numpy as np
import pytest
import torch

from conftest import load_fixture

import voxtral_tpu.audio.mic as jax_mic
import voxtral_tpu_torch.audio.mic as port_mic
import voxtral_tpu_torch.audio.native as port_native
from voxtral_tpu.audio import mel as jax_mel
from voxtral_tpu.audio import native as jax_native
from voxtral_tpu.audio import wav as jax_wav
from voxtral_tpu_torch.audio import mel as port_mel
from voxtral_tpu_torch.audio import wav as port_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _feeds(seed, sizes, scale=0.3):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(np.float32) * scale for n in sizes]


def _run(stream, feeds, discards=()):
    """Feed every chunk (discarding half the buffered frames after the
    feeds in `discards`), then finish; returns (feed returns, finish
    return, [(frame_offset, frames)] after each call)."""
    rets, outs = [], []
    for i, chunk in enumerate(feeds):
        rets.append(stream.feed(chunk))
        if i in discards:
            stream.discard_before(stream.frame_offset + stream.n_frames // 2)
        outs.append((stream.frame_offset, stream.frames().copy()))
    fin = stream.finish()
    outs.append((stream.frame_offset, stream.frames().copy()))
    return rets, fin, outs


RAGGED = (1600, 480, 12345, 160, 7, 6400)


@pytest.mark.parametrize("left_pad,sizes,discards", [
    (32 * 1280, RAGGED, (2,)),
    (0, (3,) * 50 + (400, 100), (10, 50)),
    (1280, (100, 3000, 7, 4096, 1600), ()),
])
def test_melstream_matches_jax(left_pad, sizes, discards):
    feeds = _feeds(7, sizes)
    want = _run(jax_mel.MelStream(left_pad_samples=left_pad), feeds, discards)
    got = _run(port_mel.MelStream(left_pad_samples=left_pad), feeds, discards)
    assert got[0] == want[0] and got[1] == want[1]
    for (go, gf), (wo, wf) in zip(got[2], want[2]):
        assert go == wo
        np.testing.assert_array_equal(gf, wf)


def test_melstream_equals_batch_mel():
    """The incremental frames are the batch log-mel of the padded signal."""
    audio = np.concatenate(_feeds(3, RAGGED))
    s = port_mel.MelStream(left_pad_samples=1280)
    frames = [s.frames().copy()]
    for chunk in np.array_split(audio, 7):
        s.feed(chunk)
        frames.append(s.frames().copy())
        s.discard_before(s.frame_offset + s.n_frames)
    s.finish()
    frames.append(s.frames())
    ref = port_mel.batch_log_mel(np.pad(audio, (1280, 0))).T
    np.testing.assert_allclose(np.concatenate(frames), ref, rtol=1e-5, atol=1e-5)


def _wav(payload: bytes, fmt: int, channels: int, rate: int, bits: int,
         data_size=None, extra_chunk=b"") -> bytes:
    block = channels * bits // 8
    fmt_chunk = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                      rate * block, block, bits)
    size = len(payload) if data_size is None else data_size
    body = b"WAVE" + extra_chunk + fmt_chunk + b"data" + struct.pack("<I", size) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _wav_cases():
    rng = np.random.RandomState(5)
    x = rng.randn(4801).astype(np.float32) * 0.3
    pcm16 = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    odd_chunk = b"LIST" + struct.pack("<I", 3) + b"abc\x00"   # odd size, padded
    return {
        "s16 mono": _wav(pcm16, 1, 1, 16000, 16),
        "s16 stereo 44.1k": _wav(pcm16, 1, 2, 44100, 16),
        "f32 mono 48k": _wav(x.astype("<f4").tobytes(), 3, 1, 48000, 32),
        "s32 mono 8k": _wav((x * 2 ** 30).astype("<i4").tobytes(), 1, 1, 8000, 32),
        "streaming size": _wav(pcm16, 1, 1, 22050, 16, data_size=0xFFFFFFFF,
                               extra_chunk=odd_chunk),
        "not riff": b"OggS" + pcm16[:64],
        "u8": _wav(bytes(range(200)), 1, 1, 16000, 8),
        "no data": b"RIFF" + struct.pack("<I", 28) + b"WAVEfmt "
                   + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16),
    }


@pytest.mark.parametrize("name", list(_wav_cases()))
def test_wav_parse_resample_load_match_jax(name, tmp_path):
    data = _wav_cases()[name]
    try:
        want = jax_wav.parse_wav_bytes(data)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            port_wav.parse_wav_bytes(data)
        return
    got = port_wav.parse_wav_bytes(data)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    for rate_out in (16000, 8000, 44100):
        np.testing.assert_array_equal(port_wav.resample_linear(got[0], got[1], rate_out),
                                      jax_wav.resample_linear(want[0], want[1], rate_out))
    path = tmp_path / "clip.wav"
    path.write_bytes(data)
    np.testing.assert_array_equal(port_wav.load_wav(str(path)), jax_wav.load_wav(str(path)))
    np.testing.assert_array_equal(port_wav.load_audio(str(path), 16000),
                                  jax_wav.load_audio(str(path), 16000))


def test_load_audio_without_ffmpeg_raises(tmp_path, monkeypatch):
    path = tmp_path / "clip.ogg"
    path.write_bytes(b"OggS" + bytes(64))
    monkeypatch.setattr("shutil.which", lambda name: None)
    for mod in (jax_wav, port_wav):
        with pytest.raises(ValueError, match="not a WAV file"):
            mod.load_audio(str(path))


@pytest.fixture(scope="module")
def native():
    if not port_native.native_available():
        pytest.skip("g++ cannot build native/voxaudio.cpp here")
    return port_native


def test_native_matches_jax_native_bit_for_bit(native):
    """One source, one set of flags: the port's library and the JAX
    binding's give the same bits."""
    if not jax_native.native_available():
        pytest.skip("the JAX binding's library is unavailable")
    for left_pad, sizes, discards in ((32 * 1280, RAGGED, (2,)),
                                      (0, (3,) * 50 + (400, 100), ())):
        feeds = _feeds(7, sizes)
        want = _run(jax_native.NativeMelStream(left_pad_samples=left_pad), feeds, discards)
        got = _run(native.NativeMelStream(left_pad_samples=left_pad), feeds, discards)
        assert got[0] == want[0] and got[1] == want[1]
        for (go, gf), (wo, wf) in zip(got[2], want[2]):
            assert go == wo
            np.testing.assert_array_equal(gf, wf)
    s = np.random.RandomState(9).randn(44100).astype(np.float32)
    for rate in (44100, 48000, 8000, 16000):
        np.testing.assert_array_equal(native.resample_linear_native(s, rate, 16000),
                                      jax_native.resample_linear_native(s, rate, 16000))


@pytest.mark.parametrize("left_pad,sizes,discards", [
    (32 * 1280, RAGGED, (2,)),
    (0, (3,) * 50 + (400, 100), ()),
])
def test_native_within_numpy(native, left_pad, sizes, discards):
    """The native frames against the numpy MelStream: the same frame
    counts and feed returns, values within 2e-4 (its own DFT sums)."""
    feeds = _feeds(8, sizes)
    ref = _run(port_mel.MelStream(left_pad_samples=left_pad), feeds, discards)
    nat = _run(native.NativeMelStream(left_pad_samples=left_pad), feeds, discards)
    assert nat[0] == ref[0] and nat[1] == ref[1]
    for (no, nf), (ro, rf) in zip(nat[2], ref[2]):
        assert no == ro and nf.shape == rf.shape
        np.testing.assert_allclose(nf, rf, rtol=2e-4, atol=2e-4)
    s = np.random.RandomState(9).randn(44100).astype(np.float32)
    for rate in (44100, 48000, 8000, 16000):
        a = port_wav.resample_linear(s, rate, 16000)
        b = native.resample_linear_native(s, rate, 16000)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_vox_native_switch(native, monkeypatch):
    """make_mel_stream: native when the library builds, numpy with
    VOX_NATIVE=0."""
    assert isinstance(native.make_mel_stream(1280), native.NativeMelStream)
    monkeypatch.setenv("VOX_NATIVE", "0")
    assert not native.native_available()
    assert isinstance(native.make_mel_stream(1280), port_mel.MelStream)


def test_native_builds_into_build_dir(native, tmp_path, monkeypatch):
    """A fresh build lands in the build directory (build/native/ by
    default), named by the source's hash, and leaves the JAX binding's
    native/libvoxaudio.so and the source untouched, bytes and mtimes."""
    assert native.BUILD_DIR == os.path.join(REPO, "build", "native")
    tracked = os.path.join(REPO, "native", "libvoxaudio.so")
    before = {p: (os.stat(p).st_mtime_ns, open(p, "rb").read())
              for p in (tracked, native.SRC) if os.path.exists(p)}
    assert native.SRC in before
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    assert native._load() is not None
    assert os.listdir(tmp_path / "native") == [os.path.basename(native.lib_path())]
    after = {p: (os.stat(p).st_mtime_ns, open(p, "rb").read()) for p in before}
    assert after == before


def test_mic_capture_cmds_match_jax(monkeypatch):
    for found in (("arecord", "ffmpeg"), ("ffmpeg",), ("arecord",), ()):
        monkeypatch.setattr("shutil.which",
                            lambda name, found=found: f"/bin/{name}" if name in found else None)
        for rate in (16000, 8000):
            assert port_mic._capture_cmds(rate) == jax_mic._capture_cmds(rate)
    with pytest.raises(RuntimeError, match="no microphone backend"):
        port_mic.MicSource().start()


class _FakeMic:
    """Stands in for MicSource: hands out scripted chunks, then reports the
    capture process gone."""
    script: list = []

    def __init__(self, rate):
        self.chunks = list(self.script)
        self.stopped = False

    def start(self):
        pass

    def read(self):
        if not self.chunks:
            raise RuntimeError("capture process exited (code 0)")
        return self.chunks.pop(0)

    def stop(self):
        self.stopped = True


class _Recorder:
    def __init__(self):
        self.events = []

    def feed(self, w):
        self.events.append(("feed", w.size, float(np.sum(w))))

    def flush(self):
        self.events.append(("flush",))

    def finish(self):
        self.events.append(("finish",))


def test_mic_loop_matches_jax(monkeypatch):
    """The live loop's RMS gate, silence flush and over-buffer catch-up
    take the same decisions in both packages on one scripted capture."""
    rng = np.random.RandomState(4)
    voice = lambda n: (rng.randn(n) * 0.2).astype(np.float32)   # noqa: E731
    quiet = lambda n: np.zeros(n, np.float32)                     # noqa: E731
    _FakeMic.script = [voice(1234), quiet(16000), voice(900), np.zeros(0, np.float32),
                       voice(6 * 16000 + 77), quiet(12000), voice(55)]
    logs = []
    for mod in (jax_mic, port_mic):
        monkeypatch.setattr(mod, "MicSource", _FakeMic)
        rec, drains, msgs = _Recorder(), [], []
        mod.mic_loop(rec, lambda s, d=drains: d.append(len(s.events)), rate=16000,
                     log=msgs.append)
        logs.append((rec.events, drains, msgs))
    assert logs[1] == logs[0]
    events = logs[0][0]
    assert ("flush",) in events and events[-1] == ("finish",)


@pytest.mark.parametrize("clip,fixture", [("padded", "mel_padded"), ("audio", "mel")])
def test_batch_log_mel_device_matches_jax_and_the_fixture(clip, fixture):
    """batch_log_mel_device on the CPU against batch_log_mel_jax, the host
    batch_log_mel and the reference's mel, within tests/test_mel.py's
    tolerance (f32 products in another order)."""
    g = load_fixture("mel.npz")
    ours = port_mel.batch_log_mel_device(g[clip], device="cpu")
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    got = ours.numpy()
    for ref in (np.asarray(jax_mel.batch_log_mel_jax(g[clip])),
                port_mel.batch_log_mel(g[clip]), g[fixture]):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)
    again = port_mel.batch_log_mel_device(torch.from_numpy(g[clip]), device="cpu")
    assert torch.equal(again, ours)


def test_batch_log_mel_device_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_mel.batch_log_mel_device(np.zeros(3200, np.float32))
