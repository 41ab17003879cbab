"""The port's ``fft``, ``signal`` and ``linalg`` modules against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both.  Tolerances, f32 inputs
(complex64 results): rtol 1e-5 with an absolute floor of 1e-5 of the
largest magnitude compared (pocketfft and XLA's FFT sum in other
orders); the frequency helpers and the shifts exactly up to f32
rounding (rtol 1e-7); ``stft`` / ``istft`` the same 1e-5 floor, and
``istft(stft(x))`` returns ``x`` within 1e-4; ``linalg`` at rtol 1e-5
with the same floor.  ``ihfft2`` (and ``ihfftn`` over two axes) raise in
both packages: ``ihfft`` takes a real input, and the composition hands it
a complex one.

The spec is ``tests/test_fft_linalg_incubate_opt.py:11-62``; its window
comes from ``paddle_tpu.audio`` (the next slice), so the Hann window is
made here in numpy.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle

import paddle_tpu_torch as paddle
from _torch_cpu_place import cpu_place  # noqa: F401,E402

torch.set_num_threads(1)


def _np(v):
    if isinstance(v, (jpaddle.Tensor, paddle.Tensor)):
        return v.numpy()
    return np.asarray(v)


def _close(got, want, rtol=1e-5, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    floor = rtol * max(float(np.abs(want).max()), 1.0) if want.size else 0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


def _both(name, arr, *args, mod="fft", **kw):
    out = [getattr(getattr(pkg, mod), name)(pkg.to_tensor(arr), *args, **kw)
           for pkg in (jpaddle, paddle)]
    _close(out[1], out[0], what=f"{name}{args}{kw}")
    return out[1]


RS = np.random.RandomState(0)
REAL = RS.standard_normal((4, 6, 10)).astype(np.float32)
CPLX = (RS.standard_normal((4, 6, 10)) + 1j * RS.standard_normal(
    (4, 6, 10))).astype(np.complex64)


@pytest.mark.parametrize("name, norm", [
    ("fft", "backward"), ("fft", "ortho"), ("fft", "forward"),
    ("ifft", "ortho"), ("rfft", "forward"), ("irfft", "backward"),
    ("hfft", "ortho"), ("ihfft", "forward")])
def test_one_axis_transforms_match_jax(name, norm):
    x = REAL if name in ("rfft", "ihfft") else CPLX
    _both(name, x, norm=norm)
    _both(name, x, 8, 1, norm=norm)             # n and axis


@pytest.mark.parametrize("name, norm", [
    ("fft2", "ortho"), ("ifft2", "backward"), ("rfft2", "backward"),
    ("irfft2", "ortho"), ("hfft2", "backward"), ("fftn", "backward"),
    ("ifftn", "ortho"), ("rfftn", "ortho"), ("irfftn", "backward"),
    ("hfftn", "ortho")])
def test_many_axis_transforms_match_jax(name, norm):
    x = REAL if name.startswith("rfft") else CPLX
    _both(name, x, norm=norm)
    axes = (0, 2) if name.endswith("2") else (0, 1, 2)
    s = (4, 8) if name.endswith("2") else (4, 6, 8)
    _both(name, x, s, axes, norm=norm)


def test_inverse_hermitian_compositions_raise_as_in_jax():
    out = _both("ihfftn", REAL[0, 0], axes=(0,))   # one axis: ihfft
    assert out.shape == [6]
    for name in ("ihfft2", "ihfftn"):
        with pytest.raises(ValueError):
            getattr(jpaddle.fft, name)(jpaddle.to_tensor(REAL))
        with pytest.raises(RuntimeError):
            getattr(paddle.fft, name)(paddle.to_tensor(REAL))


def test_frequencies_and_shifts_match_jax():
    for n, d in ((10, 0.1), (7, 2.5)):
        for name in ("fftfreq", "rfftfreq"):
            got = getattr(paddle.fft, name)(n, d)
            want = getattr(jpaddle.fft, name)(n, d)
            _close(got, want, rtol=1e-7, what=name)
    for name in ("fftshift", "ifftshift"):
        _both(name, REAL, mod="fft")
        _both(name, REAL, (0, 2), mod="fft")
    assert paddle.fft.is_complex(paddle.to_tensor(CPLX))


def test_fft_roundtrip_and_numpy():
    x = RS.standard_normal((8, 64)).astype(np.float32)
    back = paddle.fft.ifft(paddle.fft.fft(paddle.to_tensor(
        x.astype(np.complex64))))
    np.testing.assert_allclose(back.numpy().real, x, atol=1e-5)
    rec = paddle.fft.irfft(paddle.fft.rfft(paddle.to_tensor(x)), n=64)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5)
    x64 = RS.standard_normal((4, 16))
    out = paddle.fft.fft2(paddle.to_tensor(x64.astype(np.complex128)))
    np.testing.assert_allclose(out.numpy(), np.fft.fft2(x64), rtol=1e-10)
    t = paddle.fft.fft(torch.from_numpy(x))       # torch in, torch out
    assert type(t) is torch.Tensor and t.dtype == torch.complex64


# -- signal -------------------------------------------------------------------

def _hann(n):
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


# 7 to 9 frames each (the JAX istft adds its frames one op at a time)
STFT_CASES = [
    dict(n_fft=32, hop_length=16, window=_hann(32)),
    dict(n_fft=32, win_length=24, window=None, center=False,
         normalized=True),
    dict(n_fft=32, hop_length=16, window=_hann(24), pad_mode="constant",
         onesided=False),
]


@pytest.mark.parametrize("case", range(len(STFT_CASES)))
def test_stft_and_istft_match_jax(case):
    kw = STFT_CASES[case]
    x = RS.standard_normal((2, 96)).astype(np.float32)
    spec = _both("stft", x, mod="signal", **kw)
    if case == 0:
        _both("stft", x[0], mod="signal", **kw)     # a 1-D signal
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    got = paddle.signal.istft(spec, length=96, **ikw)
    want = jpaddle.signal.istft(jpaddle.to_tensor(spec.numpy()), length=96,
                                **ikw)
    _close(got, want, what="istft")
    if kw.get("center", True) and kw.get("onesided", True):
        np.testing.assert_allclose(got.numpy(), x, atol=1e-4)


def test_stft_istft_roundtrip_at_the_spec_shape():
    x = RS.standard_normal((2, 2048)).astype(np.float32)
    win = _hann(256)
    spec = paddle.signal.stft(paddle.to_tensor(x), n_fft=256, hop_length=64,
                              window=win)
    assert tuple(spec.shape) == (2, 129, 1 + 2048 // 64)
    rec = paddle.signal.istft(spec, n_fft=256, hop_length=64, window=win,
                              length=2048)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-4)
    assert paddle.signal.frame is paddle.ops.extended.frame


# -- linalg -------------------------------------------------------------------

def test_linalg_namespace_matches_jax():
    a = RS.standard_normal((4, 4)).astype(np.float32) + 4 * np.eye(
        4, dtype=np.float32)
    b = RS.standard_normal((4, 2)).astype(np.float32)
    for name, args in (("inv", ()), ("det", ()), ("cond", ())):
        _both(name, a, *args, mod="linalg")
    got = paddle.linalg.solve(paddle.to_tensor(a), paddle.to_tensor(b))
    want = jpaddle.linalg.solve(jpaddle.to_tensor(a), jpaddle.to_tensor(b))
    _close(got, want)
    lu_p = paddle.linalg.lu(paddle.to_tensor(a))
    lu_j = jpaddle.linalg.lu(jpaddle.to_tensor(a))
    for g, w in zip(lu_p, lu_j):
        _close(g, w)
    for g, w in zip(paddle.linalg.lu_unpack(*lu_p[:2]),
                    jpaddle.linalg.lu_unpack(*lu_j[:2])):
        _close(g, w)
    inv = paddle.linalg.inv(paddle.to_tensor(a)).numpy()
    np.testing.assert_allclose(inv @ a, np.eye(4), atol=1e-5)
