"""The port's ``audio`` against the JAX package's, on the CPU.

The same numpy-seeded clips (1-2 s at 8-16 kHz) go through both
packages' layers: f32 outputs within 1e-5 relative, with an absolute
floor of 1e-5 of the largest magnitude compared (pocketfft and XLA's FFT
sum in other orders).  The functional helpers (windows, mel scales,
filterbanks, DCT matrices) are built in numpy by both and agree to
float64 rounding, in float64, the JAX package's dtype under its default
config (``jax_enable_x64`` is on at its import).  Where the JAX package
promotes ``power_to_db``'s f32 input to float64 (its log of the Python
``ref_value`` is a strong float64), the port keeps f32: values are held,
not the dtype.

The spec is ``tests/test_text_audio_sparse_autograd.py:87-131``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.audio as ja

import _torch_global_state as global_state
import paddle_tpu_torch as paddle
import paddle_tpu_torch.audio as pa
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _global_state_unchanged():
    before = global_state.snapshot()
    yield
    assert global_state.snapshot() == before


def _close(got, want, rtol=1e-5, what=""):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = rtol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


RS = np.random.RandomState(0)
CLIPS = RS.standard_normal((2, 16000)).astype(np.float32)   # 1 s, 16 kHz


@pytest.mark.parametrize("window", [
    "hann", "hamming", "blackman", "bohman", "rect", "triang",
    ("gaussian", 7.0), "gaussian"])
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window_matches_jax(window, fftbins):
    want = ja.functional.get_window(window, 64, fftbins=fftbins)
    got = pa.functional.get_window(window, 64, fftbins=fftbins)
    assert got.dtype == torch.float64 and want.numpy().dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    got32 = pa.functional.get_window(window, 64, fftbins, dtype="float32")
    assert got32.dtype == torch.float32


def test_unknown_window_raises_in_both():
    for mod in (ja, pa):
        with pytest.raises(ValueError, match="unknown window"):
            mod.functional.get_window("kaiser", 16)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scales_and_matrices_match_jax(htk):
    jf, pf = ja.functional, pa.functional
    f = np.array([0.0, 440.0, 999.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_allclose(pf.hz_to_mel(f, htk), jf.hz_to_mel(f, htk),
                               rtol=1e-12)
    m = jf.hz_to_mel(f, htk)
    np.testing.assert_allclose(pf.mel_to_hz(m, htk), jf.mel_to_hz(m, htk),
                               rtol=1e-12)
    np.testing.assert_allclose(pf.mel_to_hz(pf.hz_to_mel(f, htk), htk), f,
                               rtol=1e-9, atol=1e-9)
    for got, want in (
            (pf.mel_frequencies(40, 20.0, 8000.0, htk),
             jf.mel_frequencies(40, 20.0, 8000.0, htk)),
            (pf.fft_frequencies(16000, 512), jf.fft_frequencies(16000, 512)),
            (pf.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk),
             jf.compute_fbank_matrix(16000, 512, 40, 20.0, None, htk)),
            (pf.compute_fbank_matrix(16000, 512, 26, norm=None, htk=htk),
             jf.compute_fbank_matrix(16000, 512, 26, norm=None, htk=htk)),
            (pf.create_dct(13, 40), jf.create_dct(13, 40)),
            (pf.create_dct(13, 40, norm=None),
             jf.create_dct(13, 40, norm=None))):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("top_db", [None, 80.0, 10.0])
def test_power_to_db_matches_jax_with_a_batch_wide_floor(top_db):
    x = (RS.uniform(0, 1, (2, 5, 7)) ** 8).astype(np.float32)
    x[1] *= 1e-4                  # the second clip far below the first
    want = ja.functional.power_to_db(jpaddle.to_tensor(x), 2.0, 1e-10,
                                     top_db)
    got = pa.functional.power_to_db(paddle.to_tensor(x), 2.0, 1e-10, top_db)
    assert got.dtype == torch.float32
    _close(got, want.numpy().astype(np.float32))
    if top_db is not None:
        # the floor is the whole batch's maximum less top_db
        floor = got.numpy().max() - top_db
        assert got.numpy().min() >= floor - 1e-4
        assert np.isclose(got.numpy()[1], floor).any()


LAYERS = {
    "Spectrogram": dict(n_fft=256, hop_length=64),
    "Spectrogram-window": dict(n_fft=512, win_length=400, hop_length=160,
                               window="hamming", power=1.0),
    "Spectrogram-complexabs": dict(n_fft=128, power=None, center=False),
    "MelSpectrogram": dict(sr=16000, n_fft=512, hop_length=160, n_mels=40,
                           f_min=20.0),
    "MelSpectrogram-htk": dict(sr=16000, n_fft=400, n_mels=64, htk=True,
                               norm=None, pad_mode="constant"),
    "LogMelSpectrogram": dict(sr=16000, n_fft=512, hop_length=160,
                              n_mels=40, top_db=80.0),
    "MFCC": dict(sr=16000, n_mfcc=13, n_fft=512, hop_length=160,
                 n_mels=40),
    "MFCC-edge": dict(sr=16000, n_mfcc=20, n_fft=256, n_mels=32,
                      pad_mode="edge", top_db=60.0),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_match_jax(name):
    cls, kw = name.split("-")[0], LAYERS[name]
    want = getattr(ja, cls)(**kw)(jpaddle.to_tensor(CLIPS))
    layer = getattr(pa, cls)(**kw)
    got = layer(paddle.to_tensor(CLIPS))
    assert isinstance(got, paddle.Tensor) and got.dtype == torch.float32
    _close(got, want.numpy().astype(np.float32), what=name)
    # a bare torch tensor gives a torch tensor; a 1-D clip its own shape
    raw = layer(torch.from_numpy(CLIPS[0]))
    assert isinstance(raw, torch.Tensor)
    _close(raw.numpy(), got.numpy()[0], what=f"{name} 1-D")
    assert dict(layer.state_dict()) == {}


def test_pad_modes_outside_the_map_raise():
    with pytest.raises(ValueError, match="pad_mode"):
        pa.Spectrogram(n_fft=64, pad_mode="symmetric")(
            paddle.to_tensor(CLIPS))


def test_float64_layers_keep_float64():
    x = CLIPS.astype(np.float64)
    want = ja.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32,
                   dtype="float64")(jpaddle.to_tensor(x))
    got = pa.MFCC(sr=16000, n_mfcc=13, n_fft=256, n_mels=32,
                  dtype="float64")(paddle.to_tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(want.numpy()).max())


# -- the JAX package's spec tests, on the port ------------------------------

def test_spec_spectrogram_parseval():
    x = np.random.RandomState(0).randn(2, 2048).astype("float32")
    spec = pa.Spectrogram(n_fft=256, hop_length=64, window="hann", power=2.0)
    out = spec(paddle.to_tensor(x))
    assert out.shape[0] == 2 and out.shape[1] == 1 + 256 // 2
    assert (out.numpy() >= 0).all()
    # Parseval: a rect-windowed frame's energy, sum |X_k|^2 / n over the
    # full spectrum, is the one-sided power spectrum folded back
    rect = pa.Spectrogram(n_fft=256, hop_length=256, window="rect",
                          center=False)(paddle.to_tensor(x)).numpy()
    full = rect[:, 1:-1].sum(1) * 2 + rect[:, 0] + rect[:, -1]
    frames = x[:, :2048].reshape(2, 8, 256)
    np.testing.assert_allclose(full / 256, (frames ** 2).sum(-1), rtol=1e-4)


def test_spec_pure_tone_peaks_at_right_bin():
    sr, n_fft = 8000, 512
    tt = np.arange(sr, dtype="float32") / sr
    x = np.sin(2 * np.pi * 1000.0 * tt).astype("float32")
    out = pa.Spectrogram(n_fft=n_fft, hop_length=n_fft,
                         power=2.0)(paddle.to_tensor(x[None])).numpy()[0]
    assert abs(int(out.mean(axis=-1).argmax()) -
               round(1000.0 * n_fft / sr)) <= 1


def test_spec_mel_and_mfcc_shapes():
    x = paddle.to_tensor(np.random.RandomState(2).randn(1, 4096)
                         .astype("float32"))
    assert pa.MelSpectrogram(sr=16000, n_fft=512, n_mels=40)(x).shape[1] \
        == 40
    assert pa.LogMelSpectrogram(sr=16000, n_fft=512,
                                n_mels=40)(x).shape[1] == 40
    assert pa.MFCC(sr=16000, n_mfcc=13, n_fft=512,
                   n_mels=40)(x).shape[1] == 13


def test_spec_fbank_matrix_rows_cover_spectrum():
    fb = pa.functional.compute_fbank_matrix(16000, 512, n_mels=26).numpy()
    assert fb.shape == (26, 257)
    assert (fb >= 0).all()
    assert (fb.sum(axis=1) > 0).all()
