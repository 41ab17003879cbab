"""The op sweep's inputs, and the parity check of the port's ops.

``SPECS`` is ``tests/test_op_registry_sweep.py``'s table (op name ->
(args builder, kwargs, check_grad)), read from that file's source
without importing it, so card tests that must not import JAX can use it
too: the statements from ``rng = ...`` up to ``SKIP = ...`` run with
numpy only.

:func:`run_op` calls one registered op of a package on the same numpy
inputs, as the sweep does (float arrays differentiable where the spec
marks the op), and returns its outputs and the inputs' gradients as
numpy.  :func:`assert_same` holds two such runs together: dtype names,
shapes, values (f32: 1e-5 relative, 1e-6 absolute for values near 0;
:func:`tolerance` names the exceptions) and gradients.
"""
from __future__ import annotations

import ast
import os
import zlib

import numpy as np

_SWEEP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "test_op_registry_sweep.py")


def _load_specs():
    tree = ast.parse(open(_SWEEP).read())
    body, on = [], False
    for node in tree.body:
        targets = [t.id for t in getattr(node, "targets", [])
                   if isinstance(t, ast.Name)]
        if "rng" in targets:
            on = True
        if "SKIP" in targets:
            break
        if on:
            body.append(node)
    ns = {"np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), _SWEEP, "exec"), ns)
    return ns["SPECS"], ns["rng"]


SPECS, _RNG = _load_specs()


def inputs(name):
    """The spec's numpy arguments for ``name``, drawn from a stream seeded
    by the name (the sweep's shared stream would depend on which tests ran
    before in the worker)."""
    _RNG.seed(zlib.crc32(name.encode()))
    return SPECS[name][0]()

# arguments the port takes in another layout than the JAX package, with
# the reason (none since F.fused_ln_linear takes the JAX [K, M] weight)
PORT_ARGS = {}
# ... and their gradients back in the JAX package's layout
PORT_GRADS = {}


def _sign_normalized_svd(outs):
    """U, S, Vh with each singular pair's sign fixed (the largest |entry|
    of U's column positive): SVD determines them up to that sign."""
    (du, u), s, (dv, vh) = outs
    j = np.argmax(np.abs(u), axis=0)
    sign = np.sign(u[j, np.arange(u.shape[1])])
    return [(du, u * sign), s, (dv, vh * sign[:, None])]


# f32 through a decomposition, an inverse or a solve amplifies rounding
# by the draw's condition number: the ops tests/test_op_gradcheck.py
# names conditioning-sensitive are held to 1e-4 relative, 1e-5 absolute
CONDITIONED = {"eig", "eigh", "svd", "qr", "lstsq", "pinv", "cholesky",
               "cholesky_solve", "matrix_power", "inverse", "det", "slogdet",
               "solve", "triangular_solve"}


def tolerance(name):
    """(rtol, atol) of the CPU sweep for ``name``."""
    return (1e-4, 1e-5) if name in CONDITIONED else (1e-5, 1e-6)


def _phase_normalized_eig(outs):
    """Eigenpairs in the order of their eigenvalues (real part, then
    imaginary), each eigenvector's phase fixed (its largest |entry| real
    and positive): solvers agree on the pairs up to order and phase."""
    (dw, w), (dv, v) = outs
    order = np.lexsort((np.imag(w), np.real(w)))
    w, v = w[order], v[:, order]
    j = np.argmax(np.abs(v), axis=0)
    pivot = v[j, np.arange(v.shape[1])]
    return [(dw, w), (dv, v * (np.abs(pivot) / pivot))]


def _sign_normalized_qr(outs):
    """Q and R with R's diagonal non-negative (Householder solvers may
    flip a column of Q and the matching row of R)."""
    (dq, q), (dr, r) = outs
    sign = np.where(np.diag(r) < 0, -1.0, 1.0).astype(r.dtype)
    return [(dq, q * sign), (dr, r * sign[:, None])]


# outputs compared after a normalisation, with the reason
NORMALIZE = {"svd": _sign_normalized_svd, "eigh": _phase_normalized_eig,
             "eig": _phase_normalized_eig, "qr": _sign_normalized_qr}


def _to_tensor(pkg, v, diff):
    if isinstance(v, np.ndarray):
        sg = not (diff and np.issubdtype(v.dtype, np.floating))
        return pkg.to_tensor(v, stop_gradient=sg)
    if isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
        return type(v)(_to_tensor(pkg, e, diff) for e in v)
    return v


def run_op(pkg, op, raw, kwargs, check_grad, dtype_name):
    """``([(dtype name, value)], [grad or None])`` of one call."""
    args = tuple(_to_tensor(pkg, v, check_grad) for v in raw)
    out = op(*args, **kwargs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    res = [(dtype_name(o.dtype), o.numpy()) for o in outs]
    grads = []
    if check_grad:
        loss = None
        for o in outs:
            if dtype_name(o.dtype).startswith(("float", "bfloat")):
                s = o.astype("float32").sum()
                loss = s if loss is None else loss + s
        if loss is not None:
            loss.backward()
            for a in args:
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if hasattr(t, "stop_gradient") and not t.stop_gradient:
                        grads.append(None if t.grad is None
                                     else t.grad.numpy())
    return res, grads


def _close(got, want, what, rtol, atol):
    kind = np.complex128 if np.iscomplexobj(want) or np.iscomplexobj(got) \
        else np.float64
    np.testing.assert_allclose(np.asarray(got, kind), np.asarray(want, kind),
                               rtol=rtol, atol=atol, err_msg=what)


def assert_same(name, want, got, rtol=1e-5, atol=1e-6):
    (wo, wg), (go, gg) = want, got
    if name in NORMALIZE:
        wo, go = NORMALIZE[name](wo), NORMALIZE[name](go)
    assert len(wo) == len(go), f"{name}: {len(wo)} vs {len(go)} outputs"
    for i, ((wd, wv), (gd, gv)) in enumerate(zip(wo, go)):
        assert wd == gd, f"{name} output {i}: dtype {gd} != {wd}"
        assert np.shape(wv) == np.shape(gv), \
            f"{name} output {i}: shape {np.shape(gv)} != {np.shape(wv)}"
        _close(gv, wv, f"{name} output {i}", rtol, atol)
    assert len(wg) == len(gg), f"{name}: {len(wg)} vs {len(gg)} grads"
    for i, (w, g) in enumerate(zip(wg, gg)):
        assert (w is None) == (g is None), f"{name} grad {i}: None mismatch"
        if w is not None:
            _close(g, w, f"{name} grad {i}", rtol, atol)
