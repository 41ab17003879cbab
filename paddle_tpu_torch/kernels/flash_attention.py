"""Flash attention, forward and backward: CUDA kernels for Hopper beside
their plain PyTorch versions.

Replaces the Pallas TPU kernels of ``paddle_tpu/kernels/flash_attention.py``:

* ``_flash_fwd`` -> ``_fwd_kernel`` (separate q, k, v; through
  :func:`flash_attention_bthd`) and ``_flash_fused_fwd_impl`` (one fused
  qkv operand; through :func:`flash_attention_qkv_fused`) by
  ``csrc/flash_attention_fwd.cu``.  It reads q, k, v and writes out
  through element strides, so the role views of one ``[B, T, nh, 3, hd]``
  projection go in without a copy;
* ``_bwd_fused_kernel`` (single tile, separate or fused operands) and the
  FA2 split ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` by
  ``csrc/flash_attention_bwd.cu``: a dk/dv kernel and a dq kernel that
  serve every T.  For the fused operand they write dq, dk and dv into the
  role slices of one ``[B, T, nh, 3, hd]`` gradient buffer.

Both take float32 or bfloat16; softmax state, sums and the lse are f32.
float32 runs f32-FMA kernels (no TF32); bfloat16 runs tensor-core
kernels: TMA loads bf16 tiles into mbarrier rings and ``wgmma`` multiplies
them, with the softmax on the f32 accumulators.  TMA reads through a 4-D
tensor map built per call over each operand's strides
(:func:`_tma_layout`), so a bf16 operand's base and strides must be
16-byte aligned; a strided view that is not raises ``ValueError`` before
any launch.  The backward's ``delta = rowsum(dO * O)`` is a kernel of its
own (``csrc/flash_attention_bwd.cu``), launched before dk/dv and dq.
``_Flash`` and ``_FlashFused`` are the ``torch.autograd.Function``
counterparts of the two ``custom_vjp`` s: each saves (operands, out, lse)
and its backward runs the backward kernels.

What bounds them on the H100, and what the designs do about it, is in the
notes at the top of each source.  :func:`flash_cost` and
:func:`flash_bwd_cost` give the analytic flops and bytes.

Every wrapper picks the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The plain versions compute in
f32 from the operands and round the result to the operands' type, as the
kernels do.  Launch counters: ``flash_attention_bthd.launches`` and
``flash_attention_qkv_fused.launches`` (forward), and ``launches_delta``,
``launches_dkv`` / ``launches_dq`` on :func:`flash_attention_bwd`
(separate operands) and :func:`flash_attention_qkv_fused_bwd` (fused
operand); ``launches_dead`` on ``flash_attention_bthd`` and
:func:`flash_attention_bwd` counts the pass over causal rows with no live
key (Tq > Tk), which the fused operand (Tq = Tk) never runs.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention_bthd", "flash_attention_plain", "dead_rows",
           "flash_attention_qkv_fused", "flash_attention_qkv_fused_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_qkv_fused_bwd",
           "flash_attention_qkv_fused_bwd_plain", "flash_cost",
           "flash_bwd_cost", "sdpa_ref", "NEG_INF"]

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the reference's largest q and kv tiles (``_block_sizes``,
# paddle_tpu/kernels/flash_attention.py:42-47), which decide its result on
# causal rows with no live key
_REF_TILE = 1024


def _scores(q, k, mask, causal, scale):
    """Scaled f32 scores ``[B, H, Tq, Tk]``: the causal mask's diagonal is
    shifted by ``Tk - Tq`` and masked entries are -1e30, not -inf;
    ``mask`` is boolean (True attends) or additive."""
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        cm = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(Tk - Tq)
        s = torch.where(cm, s, torch.full_like(s, NEG_INF))
    if mask is not None:
        if mask.dtype == torch.bool:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        else:
            s = s + mask.to(s.dtype)
    return s.float()


def sdpa_ref(q, k, v, mask, causal, scale, dropout_p=0.0, generator=None):
    """``_sdpa_ref`` of the JAX package on ``[B, T, H, D]``: scores, f32
    softmax, ``@ v``.  ``mask`` is broadcast against ``[B, H, Tq, Tk]``.
    With ``dropout_p`` the probabilities are dropped with keep probability
    ``1 - dropout_p`` and rescaled, the keep mask drawn from
    ``generator`` (torch's default generator when None): the same
    distribution as the JAX draw, not the same bits."""
    probs = torch.softmax(_scores(q, k, mask, causal, scale), dim=-1)
    probs = probs.to(q.dtype)
    if dropout_p:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] q, k and v")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def _split_qkv(qkv):
    """The q, k and v role views of a fused ``[B, T, nh, 3, hd]`` tensor
    (no copy)."""
    if qkv.dim() != 5 or qkv.shape[3] != 3:
        raise ValueError(f"fused qkv must be [B, T, nh, 3, hd], got "
                         f"{tuple(qkv.shape)}")
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def dead_rows(Tq, Tk):
    """The reference's result on the causal rows ``i < Tq - Tk``, which
    have no live key, follows its tiles (``_block_sizes``: bq = min(1024,
    Tq), bk = min(1024, Tk)).  Every score of such a row is -1e30, so each
    kv tile that its q tile visits (``j*bk <= q_tile*bq + bq - 1 +
    Tk - Tq``; every tile in the one-pass forward of a single kv tile)
    gives p = 1 on all bk columns, the padding past Tk included, and its
    lse is -1e30.  Returns two lists over those rows: ``L``, the
    forward's columns with p = 1 (its output is the sum of v over the
    first ``min(L, Tk)`` keys divided by L; 0 when no tile is visited:
    a zero row), and ``cb``, the keys with p = 1 in the backward (the
    single-tile kernel when one q and one kv tile cover the call, else
    the split kernels' visited tiles).  ``csrc/flash_common.cuh``'s
    ``DeadRule`` computes the same."""
    bq, bk = min(_REF_TILE, Tq), min(_REF_TILE, Tk)
    nq, nk = -(-Tq // bq), -(-Tk // bk)
    L, cb = [], []
    for i in range(max(0, Tq - Tk)):
        hi = (i // bq) * bq + bq - 1 + Tk - Tq
        cols = 0 if hi < 0 else min(nk, hi // bk + 1) * bk
        L.append(bk if nk == 1 else cols)
        cb.append(Tk if nq == 1 and nk == 1 else min(cols, Tk))
    return L, cb


def _dead_keys(cols, Tk, device):
    """``[len(cols), Tk]`` f32: 1 on the first ``cols[i]`` keys of row i."""
    c = torch.tensor(cols, dtype=torch.int64, device=device)
    return (torch.arange(Tk, device=device) < c[:, None]).float()


def flash_attention_plain(q, k, v, causal=True, scale=None,
                          return_lse=False):
    """The plain forward: :func:`sdpa_ref` without a mask, in f32 from the
    operands, rounded to their type; with ``return_lse`` also the f32
    logsumexp ``[B*H, Tq, 1]`` of the same scores.  Causal rows with no
    live key (Tq > Tk) follow the reference's tiles (:func:`dead_rows`)."""
    _check(q, k, v)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = sdpa_ref(qf, kf, vf, None, causal, scale)
    if causal and Tq > Tk:
        L, _ = dead_rows(Tq, Tk)
        n = torch.tensor(L, dtype=torch.float32, device=q.device)
        keys = _dead_keys([min(x, Tk) for x in L], Tk, q.device)
        sums = torch.einsum("ic,bchd->bihd", keys, vf)
        out[:, :Tq - Tk] = torch.where(
            n[:, None, None] > 0, sums / n.clamp(min=1.0)[:, None, None],
            torch.zeros((), device=q.device))
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(_scores(qf, kf, None, causal, scale), dim=-1)
    return out, lse.reshape(B * H, Tq, 1)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True,
                              scale=None):
    """The plain backward: (dq, dk, dv) recomputed from the saved lse, in
    f32, as the TPU kernels do — ``p = exp(s - lse)``, ``dv = p^T dO``,
    ``ds = p (dO v^T - rowsum(dO * O))``, ``dq = ds k * scale``,
    ``dk = ds^T q * scale`` — rounded to the operands' type.  Causal rows
    with no live key take the reference's p (:func:`dead_rows`)."""
    _check(q, k, v)
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    Tk = k.shape[1]
    qf, kf = q.float(), k.float()
    vh, oh, doh = (x.float().transpose(1, 2) for x in (v, out, do))
    p = torch.exp(_scores(qf, kf, None, causal, scale)
                  - lse.reshape(B, H, Tq, 1))
    if causal and Tq > Tk:      # rows with no live key: the reference's p
        p[:, :, :Tq - Tk] = _dead_keys(dead_rows(Tq, Tk)[1], Tk, q.device)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf.transpose(1, 2)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf.transpose(1, 2)) * scale
    return tuple(g.transpose(1, 2).to(x.dtype)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


def flash_attention_qkv_fused_plain(qkv, causal=True, scale=None,
                                    return_lse=False):
    """The plain fused forward: ``[B, T, nh, 3, hd]`` -> ``[B, T, nh*hd]``
    (and the lse ``[B*nh, T, 1]``)."""
    B, T, nh, _, hd = qkv.shape
    out, lse = flash_attention_plain(*_split_qkv(qkv), causal=causal,
                                     scale=scale, return_lse=True)
    out = out.reshape(B, T, nh * hd)
    return (out, lse) if return_lse else out


def flash_attention_qkv_fused_bwd_plain(qkv, out, lse, do, causal=True,
                                        scale=None):
    """The plain fused backward: dqkv ``[B, T, nh, 3, hd]``."""
    B, T, nh, _, hd = qkv.shape
    grads = flash_attention_bwd_plain(
        *_split_qkv(qkv), out.reshape(B, T, nh, hd), lse,
        do.reshape(B, T, nh, hd), causal=causal, scale=scale)
    return torch.stack(grads, dim=3)


def _live_pairs(Tq, Tk, causal):
    if not causal:
        return Tq * Tk
    off = Tk - Tq
    return sum(max(0, min(Tk, r + off + 1)) for r in range(Tq))


def flash_cost(B, Tq, Tk, H, D, causal=True, itemsize=4):
    """Analytic work of one forward: (flops, bytes).  Flops count QK^T and
    PV (2 flops per multiply-add) over the live (causal) pairs; bytes
    count q, k and v read once and out written once, ``itemsize`` bytes
    an element, and the f32 lse written once."""
    flops = 4.0 * B * H * _live_pairs(Tq, Tk, causal) * D
    nbytes = (itemsize * (2.0 * B * Tq * H * D + 2.0 * B * Tk * H * D)
              + 4.0 * B * H * Tq)
    return flops, nbytes


def flash_bwd_cost(B, Tq, Tk, H, D, causal=True, itemsize=4, part="all"):
    """Analytic work of one backward: (flops, bytes).  Flops count the five
    products of the algorithm (QK^T, dV, dP, dQ, dK) over the live pairs,
    not the split's second recompute of QK^T and dP; bytes count q, k, v,
    out and dO read once, the f32 lse read once, and dq, dk, dv written
    once.  ``part="dq"`` or ``"dkv"`` counts what that kernel alone must
    do: QK^T, dP and dQ (or dV and dK) from q, k, v, dO, lse and delta."""
    pairs = B * H * _live_pairs(Tq, Tk, causal) * D
    rows = 4.0 * B * H * Tq                      # one f32 per q row
    ins = itemsize * B * H * D * (2.0 * Tq + 2.0 * Tk)     # q, dO, k, v
    if part == "dq":
        return 6.0 * pairs, ins + 2 * rows + itemsize * B * H * D * Tq
    if part == "dkv":
        return 8.0 * pairs, ins + 2 * rows + itemsize * B * H * D * 2.0 * Tk
    return 10.0 * pairs, (ins + itemsize * B * H * D * (Tq + Tq + 2.0 * Tk)
                          + rows)


# -- kernel launches -----------------------------------------------------------

def _strides(x, what):
    """(batch, sequence, head) element strides of a ``[B, T, H, D]``
    operand whose head dimension is unit-stride; anything else raises
    (nothing is copied)."""
    if x.stride(-1) != 1:
        raise ValueError(f"the flash kernels read {what} with a unit-stride "
                         f"head dimension; got strides {tuple(x.stride())}")
    return list(x.stride()[:3])


def _tma_layout(x, what):
    """The 4-D TMA tensor map the bf16 kernels build over a ``[B, T, H,
    D]`` operand (``encode_map`` in ``csrc/sm90.cuh`` does the same):
    dims innermost first — D, then the head, sequence and batch dims
    ordered by byte stride, size-1 dims last with the extent of the dims
    before them as their stride — their byte strides, and the order of
    the outer three as ``"h"``, ``"t"``, ``"b"``.  Raises ``ValueError``
    where TMA cannot read the operand: a base address, or the stride of a
    dim longer than 1, that is not a multiple of 16 bytes."""
    _strides(x, what)
    B, T, H, D = x.shape
    item = x.element_size()
    if x.data_ptr() % 16:
        raise ValueError(f"the bf16 flash kernels read {what} by TMA: its "
                         f"base address must be 16-byte aligned")
    sizes = dict(h=H, t=T, b=B)
    strides = dict(h=x.stride(2) * item, t=x.stride(1) * item,
                   b=x.stride(0) * item)
    order = tuple(sorted("htb", key=lambda r: (sizes[r] == 1, 0 if
                                               sizes[r] == 1 else strides[r])))
    dims, bstrides, extent = [D], [], D * item
    for r in order:
        st = strides[r]
        if sizes[r] == 1:
            st = -(-extent // 16) * 16
        elif st % 16 or st <= 0 or st >= 1 << 40:
            raise ValueError(
                f"the bf16 flash kernels read {what} by TMA: its "
                f"{dict(h='head', t='sequence', b='batch')[r]} stride is "
                f"{st} bytes, not a positive multiple of 16")
        dims.append(sizes[r])
        bstrides.append(st)
        extent = st * sizes[r]
    return tuple(dims), tuple(bstrides), order


def _rows16(x, what):
    """A bf16 kernel output is written 16 bytes at a time along its rows:
    base and (batch, sequence, head) strides must be 16-byte aligned."""
    _strides(x, what)
    if x.data_ptr() % 16 or any(s * x.element_size() % 16
                                for s in x.stride()[:3]):
        raise ValueError(f"the bf16 flash kernels write {what} in 16-byte "
                         f"rows: base and strides must be 16-byte aligned, "
                         f"got strides {tuple(x.stride())}")


def _check_bf16(reads, writes):
    """Raise before a bf16 launch on an operand TMA cannot read or an
    output the epilogue cannot write."""
    for x, what in reads:
        _tma_layout(x, what)
    for x, what in writes:
        _rows16(x, what)


def _kernel_dtype(*xs):
    dt = xs[0].dtype
    if dt not in _DTYPE_CODE or any(x.dtype != dt for x in xs):
        raise TypeError("the flash kernels take float32 or bfloat16 "
                        "operands of one type, got "
                        f"{'/'.join(str(x.dtype) for x in xs)}")
    return _DTYPE_CODE[dt]


def _lib_for(D):
    from . import _build

    lib = _build.library()
    if lib.paddle_flash_attention_smem_bytes(D) == 0:
        raise ValueError(f"the flash kernels take head size 32, 64 or 128, "
                         f"got {D}")
    return lib


def _stride_array(*ops):
    vals = []
    for x, what in ops:
        vals += _strides(x, what)
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch_fwd(q, k, v, out, causal, scale):
    """Launch the forward kernel into ``out`` (any strides, unit-stride D)
    and, for causal Tq > Tk, the kernel that writes the rows with no live
    key (:func:`dead_rows`); returns the f32 lse ``[B*H, Tq, 1]``."""
    from . import _build

    code = _kernel_dtype(q, k, v, out)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lib = _lib_for(D)
    if code == 1:
        _check_bf16(((q, "q"), (k, "k"), (v, "v")), ((out, "out"),))
    st = _stride_array((q, "q"), (k, "k"), (v, "v"), (out, "out"))
    lse = torch.empty(B * H, Tq, 1, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paddle_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), st, B, Tq, Tk, H, D, ctypes.c_float(scale),
        int(bool(causal)), code, stream)
    _build.check(err, "flash_attention_fwd")
    if causal and Tq > Tk:      # rows with no live key: the reference's
        err = lib.paddle_flash_attention_dead_fwd(
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _stride_array((v, "v"), (out, "out")), B, Tq, Tk, H, D, code,
            stream)
        _build.check(err, "flash_attention_dead_fwd")
        flash_attention_bthd.launches_dead += 1
    return lse


def _launch_bwd(counter, q, k, v, out, lse, do, dq, dk, dv, causal, scale):
    """Launch the delta kernel (``rowsum(dO * O)``, f32 ``[B*H, Tq]``),
    the dk/dv kernel, then the dq kernel, writing into the given gradient
    views, and for causal Tq > Tk the rows with no live key (dq written,
    dk and dv added to); ``counter`` (the calling wrapper) counts each."""
    from . import _build

    code = _kernel_dtype(q, k, v, out, do, dq, dk, dv)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lib = _lib_for(D)
    lse = lse.reshape(B * H, Tq)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("the flash backward takes the forward's f32 lse")
    if code == 1:
        _check_bf16(((q, "q"), (k, "k"), (v, "v"), (do, "dO")),
                    ((dq, "dq"), (dk, "dk"), (dv, "dv")))
    st = _stride_array((q, "q"), (k, "k"), (v, "v"), (do, "dO"), (dq, "dq"),
                       (dk, "dk"), (dv, "dv"))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    delta = torch.empty(B * H, Tq, dtype=torch.float32, device=q.device)
    err = lib.paddle_flash_attention_bwd_delta(
        out.data_ptr(), do.data_ptr(), delta.data_ptr(),
        _stride_array((out, "out"), (do, "dO")), B, Tq, H, D, code, stream)
    _build.check(err, "flash_attention_bwd_delta")
    counter.launches_delta += 1
    common = (st, B, Tq, Tk, H, D, ctypes.c_float(scale), int(bool(causal)),
              code, stream)
    err = lib.paddle_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *common)
    _build.check(err, "flash_attention_bwd_dkv")
    counter.launches_dkv += 1
    err = lib.paddle_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *common)
    _build.check(err, "flash_attention_bwd_dq")
    counter.launches_dq += 1
    if causal and Tq > Tk:      # rows with no live key: the reference's
        err = lib.paddle_flash_attention_dead_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), st,
            B, Tq, Tk, H, D, ctypes.c_float(scale), code, stream)
        _build.check(err, "flash_attention_dead_bwd")
        counter.launches_dead += 1


def _on_card(x, what):
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} for device {x.device}")
    return True


def _unit_do(do):
    # a gradient arrives in whatever layout autograd produced
    return do if do.stride(-1) == 1 else do.contiguous()


# -- public wrappers -----------------------------------------------------------

def _bthd_fwd(q, k, v, causal, scale):
    if not _on_card(q, "flash attention"):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     return_lse=True)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = _launch_fwd(q, k, v, out, causal, scale)
    flash_attention_bthd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, causal=True, scale=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_bthd` from its
    saved out and lse.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the delta,
    dk/dv and dq kernels (any failure raises)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card(q, "flash attention backward"):
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                         scale=scale)
    grads = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  for x in (q, k, v))
    _launch_bwd(flash_attention_bwd, q, k, v, out, lse, _unit_do(do), *grads,
                causal, float(scale))
    return grads


class _Flash(torch.autograd.Function):
    """``_flash``'s ``custom_vjp``: saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _bthd_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def _wants_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_bthd(q, k, v, causal=True, scale=None, return_lse=False):
    """Attention in the fused-op layout: q ``[B, Tq, H, D]``, k and v
    ``[B, Tk, H, D]`` (any strides with a unit-stride D); returns out
    (shape of q) and, with ``return_lse``, the f32 logsumexp
    ``[B*H, Tq, 1]``.  Differentiable through ``_Flash`` (not with
    ``return_lse``).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (any failure raises)."""
    _check(q, k, v)
    scale = float(1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)
    if not return_lse and _wants_grad(q, k, v):
        return _Flash.apply(q, k, v, bool(causal), scale)
    out, lse = _bthd_fwd(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


def _fused_fwd(qkv, causal, scale):
    if not _on_card(qkv, "fused flash attention"):
        return flash_attention_qkv_fused_plain(qkv, causal=causal,
                                               scale=scale, return_lse=True)
    q, k, v = _split_qkv(qkv)
    B, T, nh, hd = q.shape
    out = torch.empty(B, T, nh * hd, dtype=qkv.dtype, device=qkv.device)
    lse = _launch_fwd(q, k, v, out.view(B, T, nh, hd), causal, scale)
    flash_attention_qkv_fused.launches += 1
    return out, lse


def flash_attention_qkv_fused_bwd(qkv, out, lse, do, causal=True,
                                  scale=None):
    """dqkv ``[B, T, nh, 3, hd]`` of :func:`flash_attention_qkv_fused`
    from its saved out ``[B, T, nh*hd]`` and lse.  On the card the delta
    kernel runs first, then the dk/dv and dq kernels write straight into
    the role slices of one gradient buffer (no stack); CPU tensors take
    the plain version."""
    q, k, v = _split_qkv(qkv)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_card(qkv, "fused flash attention backward"):
        return flash_attention_qkv_fused_bwd_plain(qkv, out, lse, do,
                                                   causal=causal, scale=scale)
    B, T, nh, hd = q.shape
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    _launch_bwd(flash_attention_qkv_fused_bwd, q, k, v,
                out.view(B, T, nh, hd), lse,
                _unit_do(do.reshape(B, T, nh, hd)), *_split_qkv(dqkv),
                causal, float(scale))
    return dqkv


class _FlashFused(torch.autograd.Function):
    """``_flash_fused``'s ``custom_vjp``: saves (qkv, out, lse)."""

    @staticmethod
    def forward(ctx, qkv, causal, scale):
        out, lse = _fused_fwd(qkv, causal, scale)
        ctx.save_for_backward(qkv, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        return (flash_attention_qkv_fused_bwd(qkv, out, lse, do,
                                              causal=ctx.causal,
                                              scale=ctx.scale), None, None)


def flash_attention_qkv_fused(qkv, causal=True, scale=None):
    """Self-attention on the fused head-major qkv tensor ``[B, T, nh, 3,
    hd]`` (the ``qkv_proj(x).view(...)`` of GPT), returning
    ``[B, T, nh*hd]``: the JAX ``fused_qkv_attention`` contract.  The
    kernel reads the three role views of the one buffer in place.
    Differentiable through ``_FlashFused``.

    CPU tensors take :func:`flash_attention_qkv_fused_plain`; CUDA tensors
    launch the kernel (any failure raises)."""
    _split_qkv(qkv)
    scale = float(1.0 / math.sqrt(qkv.shape[-1]) if scale is None else scale)
    if _wants_grad(qkv):
        return _FlashFused.apply(qkv, bool(causal), scale)
    return _fused_fwd(qkv, causal, scale)[0]


flash_attention_bthd.launches = 0
flash_attention_bthd.launches_dead = 0
flash_attention_qkv_fused.launches = 0
flash_attention_bwd.launches_delta = 0
flash_attention_bwd.launches_dkv = 0
flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dead = 0
flash_attention_qkv_fused_bwd.launches_delta = 0
flash_attention_qkv_fused_bwd.launches_dkv = 0
flash_attention_qkv_fused_bwd.launches_dq = 0
