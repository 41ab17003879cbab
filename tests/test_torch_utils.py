"""The port's ``utils`` against the JAX package's, on the CPU: the same
public names, ``cpp_extension`` (one C++ source built against each
package's ``paddle_ext.h``, the ops' values and gradients equal),
``dlpack``, ``unique_name``, ``deprecated``, ``download`` (local files
and archives only), ``try_import``, ``require_version``, ``run_check``
and the small names.

The spec is ``tests/test_cpp_extension.py``; its ``jit.to_static`` case
has no port counterpart (``jit`` is entry 12's programs, not ported):
the port's counterpart runs the op under ``incubate.autograd.vjp``.
"""
import io
import os
import tarfile
import textwrap
import warnings
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as jpaddle
import paddle_tpu.utils as jutils
from paddle_tpu.utils import cpp_extension as jext

import _torch_global_state as global_state
import paddle_tpu_torch as paddle
import paddle_tpu_torch.utils as putils
from _torch_cpu_place import cpu_place  # noqa: F401,E402
from paddle_tpu_torch.utils import cpp_extension as pext

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _global_state_unchanged():
    before = global_state.snapshot()
    yield
    assert global_state.snapshot() == before


_SRC = textwrap.dedent("""
    #include "paddle_ext.h"
    #include <cmath>

    // y = x^3 ; dy/dx = 3x^2
    PT_BUILD_OP(cube) {
      if (n_inputs != 1 || n_outputs != 1) return 1;
      const float* x = static_cast<const float*>(inputs[0].data);
      float* y = static_cast<float*>(outputs[0].data);
      int64_t n = 1;
      for (int d = 0; d < inputs[0].ndim; ++d) n *= inputs[0].shape[d];
      for (int64_t i = 0; i < n; ++i) y[i] = x[i] * x[i] * x[i];
      return 0;
    }

    // grad: inputs = (x, grad_y) -> grad_x
    PT_BUILD_OP(cube_grad) {
      if (n_inputs != 2 || n_outputs != 1) return 1;
      const float* x = static_cast<const float*>(inputs[0].data);
      const float* gy = static_cast<const float*>(inputs[1].data);
      float* gx = static_cast<float*>(outputs[0].data);
      int64_t n = 1;
      for (int d = 0; d < inputs[0].ndim; ++d) n *= inputs[0].shape[d];
      for (int64_t i = 0; i < n; ++i) gx[i] = 3.0f * x[i] * x[i] * gy[i];
      return 0;
    }

    // pairwise sum with broadcast-free contract: same shapes
    PT_BUILD_OP(myadd) {
      if (n_inputs != 2 || n_outputs != 1) return 1;
      const float* a = static_cast<const float*>(inputs[0].data);
      const float* b = static_cast<const float*>(inputs[1].data);
      float* y = static_cast<float*>(outputs[0].data);
      int64_t n = 1;
      for (int d = 0; d < inputs[0].ndim; ++d) n *= inputs[0].shape[d];
      for (int64_t i = 0; i < n; ++i) y[i] = a[i] + b[i];
      return 0;
    }

    // row sums of a [n, k] int64 matrix: another shape and dtype out
    PT_BUILD_OP(rowsum) {
      if (n_inputs != 1 || n_outputs != 1 || inputs[0].dtype != 3) return 2;
      const int64_t* x = static_cast<const int64_t*>(inputs[0].data);
      double* y = static_cast<double*>(outputs[0].data);
      int64_t n = inputs[0].shape[0], k = inputs[0].shape[1];
      for (int64_t i = 0; i < n; ++i) {
        y[i] = 0;
        for (int64_t j = 0; j < k; ++j) y[i] += x[i * k + j];
      }
      return 0;
    }
""")


def _load(mod, d, name):
    src = d / f"{name}.cpp"
    src.write_text(_SRC)
    return mod.load(name=name, sources=[str(src)],
                    functions=["cube", "myadd", "rowsum"],
                    grad_op_map={"cube": "cube_grad"},
                    infer_shapes={"rowsum": lambda s: (s[0],)},
                    infer_dtypes={"rowsum": lambda d: "float64"},
                    build_directory=str(d / "build"))


@pytest.fixture(scope="module")
def exts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ext")
    return _load(jext, d, "jax_ops"), _load(pext, d, "port_ops")


def test_utils_public_names_equal_jax():
    pub = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa
    assert pub(putils) >= pub(jutils) - {"cpp_extension", "dlpack",
                                         "download", "unique_name"}
    for n in ("cpp_extension", "dlpack", "download", "unique_name",
              "deprecated", "image_util", "build_native_lib",
              "get_build_directory", "try_import", "require_version",
              "run_check", "ProfilerOptions", "get_profiler",
              "OpLastCheckpointChecker"):
        assert hasattr(putils, n), n
    assert putils.image_util is paddle.dataset.image
    assert putils.get_profiler() is paddle.profiler.Profiler
    assert putils.ProfilerOptions({"a": 1}).options == {"a": 1}
    assert putils.OpLastCheckpointChecker().check("matmul")
    assert putils.build_native_lib is putils.native_build.build_native_lib
    assert putils.get_build_directory() == \
        pext.get_build_directory() == str(putils.native_build.BUILD_ROOT)


def test_the_abi_header_is_the_jax_packages():
    def abi(path):
        text = open(path).read()
        return text[text.index("#pragma once"):]

    jhdr = os.path.join(os.path.dirname(jpaddle.__file__), "csrc",
                        "paddle_ext.h")
    phdr = os.path.join(paddle.sysconfig.get_include(), "paddle_ext.h")
    assert abi(phdr) == abi(jhdr)


def test_custom_ops_match_jax(exts):
    jops, pops = exts
    x = np.random.RandomState(0).standard_normal((3, 5)).astype(np.float32)
    for name, args in (("cube", (x,)), ("myadd", (x, 2 * x))):
        want = getattr(jops, name)(*[jpaddle.to_tensor(a) for a in args])
        got = getattr(pops, name)(*[paddle.to_tensor(a) for a in args])
        assert isinstance(got, paddle.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    m = np.arange(12, dtype=np.int64).reshape(3, 4)
    got = pops.rowsum(paddle.to_tensor(m))
    assert got.dtype == torch.float64 and got.shape == [3]
    np.testing.assert_array_equal(got.numpy(),
                                  jops.rowsum(jpaddle.to_tensor(m)).numpy())
    # numpy arrays in: Tensors on the current place
    np.testing.assert_array_equal(pops.cube(x).numpy(), x * x * x)


def test_custom_op_gradients_match_jax(exts):
    jops, pops = exts
    x = np.random.RandomState(1).standard_normal((4,)).astype(np.float32)
    grads = []
    for pkg, ops in ((jpaddle, jops), (paddle, pops)):
        t = pkg.to_tensor(x)
        t.stop_gradient = False
        (ops.cube(t) * pkg.to_tensor(np.arange(4, dtype=np.float32))) \
            .sum().backward()
        grads.append(t.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)
    np.testing.assert_allclose(grads[1], 3 * x * x * np.arange(4),
                               rtol=1e-6)


def test_spec_custom_op_forward(exts):
    ops = exts[1]
    x = paddle.to_tensor(np.array([1.0, 2.0, 3.0], "float32"))
    np.testing.assert_allclose(ops.cube(x).numpy(), [1.0, 8.0, 27.0])
    a = paddle.to_tensor(np.full((2, 3), 2.0, "float32"))
    b = paddle.to_tensor(np.full((2, 3), 5.0, "float32"))
    np.testing.assert_allclose(ops.myadd(a, b).numpy(), np.full((2, 3), 7.0))


def test_spec_custom_op_grad(exts):
    x = paddle.to_tensor(np.array([1.0, 2.0], "float32"))
    x.stop_gradient = False
    exts[1].cube(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 12.0])


def test_spec_custom_op_without_grad_stops_gradient(exts):
    x = paddle.to_tensor(np.ones((2,), "float32"))
    x.stop_gradient = False
    assert exts[1].myadd(x, x).stop_gradient


def test_custom_op_under_functional_autograd(exts):
    """The counterpart of the spec's ``jit.to_static`` case: the op inside
    ``incubate.autograd.vjp`` (the autograd route: the op reads its
    inputs on the host, which ``torch.func`` cannot trace)."""
    from paddle_tpu_torch.incubate.autograd import vjp

    x = paddle.to_tensor(np.array([2.0, -1.0], "float32"))
    out, g = vjp(lambda t: exts[1].cube(t) * 2, x)
    np.testing.assert_allclose(out.numpy(), [16.0, -2.0])
    np.testing.assert_allclose(g.numpy(), [24.0, 6.0])


def test_failing_op_and_bad_dtype_raise(exts):
    ops = exts[1]
    with pytest.raises(RuntimeError, match="returned 2"):
        ops.rowsum(paddle.to_tensor(np.ones((2, 2), np.float32)))
    with pytest.raises(TypeError, match="not supported"):
        ops.cube(paddle.to_tensor(np.ones(2, np.float16)))
    with pytest.raises(ValueError, match="functions"):
        pext.load("nothing", sources=["x.cpp"])


def test_spec_setup_builds(tmp_path):
    src = tmp_path / "noop.cpp"
    src.write_text(_SRC)
    outs = pext.setup(name="noop_ext",
                      ext_modules=pext.CppExtension(sources=[str(src)]))
    assert outs and os.path.exists(outs[0])
    with pytest.raises(TypeError):
        pext.setup(name="bad", ext_modules=["not an extension"])


def test_two_sources_build_one_library_and_rebuild_on_edit(tmp_path):
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text(_SRC)
    b.write_text('#include "paddle_ext.h"\nPT_BUILD_OP(seven) '
                 '{ static_cast<float*>(outputs[0].data)[0] = 7; '
                 'return 0; }\n')
    kw = dict(functions=["cube", "seven"], build_directory=str(tmp_path))
    first = pext.load("two", [str(a), str(b)], **kw)
    one = paddle.to_tensor(np.ones(1, np.float32))
    assert float(first.seven(one).numpy()[0]) == 7.0
    b.write_text(b.read_text().replace("= 7", "= 8"))
    second = pext.load("two", [str(a), str(b)], **kw)
    assert second.__file__ != first.__file__
    assert float(second.seven(one).numpy()[0]) == 8.0


def test_spec_cuda_extension_rejected():
    with pytest.raises(RuntimeError, match="kernels/csrc"):
        pext.CUDAExtension(sources=["x.cu"])
    with pytest.raises(RuntimeError, match="Pallas"):
        jext.CUDAExtension(sources=["x.cu"])


def test_dlpack_round_trip_shares_memory():
    x = paddle.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    y = putils.dlpack.from_dlpack(putils.dlpack.to_dlpack(x))
    assert isinstance(y, paddle.Tensor)
    assert y.value.data_ptr() == x.value.data_ptr()
    np.testing.assert_array_equal(y.numpy(), x.numpy())
    # across the packages: a port tensor into the JAX package and back
    j = jutils.dlpack.from_dlpack(x.value)
    np.testing.assert_array_equal(np.asarray(j.numpy()), x.numpy())
    back = putils.dlpack.from_dlpack(jutils.dlpack.to_dlpack(j))
    np.testing.assert_array_equal(back.numpy(), x.numpy())


def test_unique_name_matches_jax():
    seqs = []
    for mod in (jutils.unique_name, putils.unique_name):
        with mod.guard():
            names = [mod.generate("fc"), mod.generate("fc"),
                     mod.generate("conv")]
            with mod.guard("block/"):
                names += [mod.generate("fc"), mod.generate("fc")]
            names.append(mod.generate("fc"))
        old = mod.switch()
        try:
            names.append(mod.generate("fc"))
        finally:
            mod.switch(old)
        seqs.append(names)
    assert seqs[1] == seqs[0] == ["fc_0", "fc_1", "conv_0", "block/fc_0",
                                  "block/fc_1", "fc_2", "fc_0"]


def test_deprecated_matches_jax():
    for mod in (jutils, putils):
        @mod.deprecated(update_to="paddle.new", since="2.0", reason="old",
                        level=1)
        def f(x):
            """Doc."""
            return x + 1

        with pytest.warns(DeprecationWarning, match="since 2.0"):
            assert f(1) == 2
        assert "Warning:" in f.__doc__ and "paddle.new" in f.__doc__

        @mod.deprecated(level=0)
        def g():
            return 3

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert g() == 3
        with pytest.raises(RuntimeError, match="deprecated"):
            mod.deprecated(level=2)(lambda: None)


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_download_resolves_local_files_and_archives(tmp_path):
    dl, jdl = putils.download, jutils.download
    plain = tmp_path / "w.bin"
    plain.write_bytes(b"weights")
    for mod in (jdl, dl):
        assert mod.get_path_from_url(str(plain), str(tmp_path)) == str(plain)
    arch = tmp_path / "pkg.tar.gz"
    _tar(arch, {"pkg/a.txt": b"a", "pkg/b.txt": b"bb"})
    outs = [mod.get_path_from_url(str(arch), str(tmp_path / n))
            for mod, n in ((jdl, "j"), (dl, "p"))]
    assert [os.path.basename(o) for o in outs] == ["pkg", "pkg"]
    assert open(os.path.join(outs[1], "b.txt")).read() == "bb"
    z = tmp_path / "z.zip"
    with zipfile.ZipFile(z, "w") as zf:
        zf.writestr("zz/c.txt", "c")
    assert dl.get_path_from_url(str(z), str(tmp_path / "zout")).endswith(
        "zz")
    from paddle_tpu_torch.dataset.common import md5file
    assert dl.get_path_from_url(str(plain), str(tmp_path),
                                md5sum=md5file(str(plain))) == str(plain)
    with pytest.raises(IOError, match="md5"):
        dl.get_path_from_url(str(plain), str(tmp_path), md5sum="0" * 32)


def test_download_refuses_missing_files_and_escaping_members(tmp_path):
    for mod in (jutils.download, putils.download):
        with pytest.raises(IOError, match="no network egress"):
            mod.get_path_from_url("https://example.invalid/x.tar",
                                  str(tmp_path))
    bad = tmp_path / "bad.tar.gz"
    _tar(bad, {"../evil.txt": b"x"})
    with pytest.raises(IOError, match="escapes"):
        putils.download.get_path_from_url(str(bad), str(tmp_path / "out"))
    assert not (tmp_path / "evil.txt").exists()


def test_try_import_require_version_run_check(capsys):
    assert putils.try_import("json") is __import__("json")
    assert putils.try_import("no_such_module_here") is None
    putils.require_version("0.0.1")
    with pytest.raises(Exception, match="required"):
        putils.require_version("999.0")
    with pytest.raises(Exception, match="maximum"):
        putils.require_version("0.0.1", "0.0.2")
    putils.run_check()
    assert "installed successfully on cpu" in capsys.readouterr().out
