"""The conv + batch-norm experiment kernels: CUDA kernels for Hopper beside
their plain PyTorch versions.

Replaces the Pallas TPU kernels of three experiment scripts, one entry
point for each JAX function, with its name and signature:

* ``fused_conv1x1_bn`` (``tools/exp_conv_bn.py:51``, ``pallas_call`` at
  ``:63``, body ``_kernel``): the bottleneck's "batch-norm apply -> relu ->
  1x1 conv -> batch-norm statistics" chain, ``y = relu(x * s + b) @ w``
  with ``stats = [sum(y), sum(y^2)]`` over rows;
* ``fused3x3`` (``tools/exp_conv3x3.py:56``, ``:62``, body ``_kernel``):
  the same prologue, a 3x3 / stride-1 / SAME conv over NHWC (zero padding
  applied AFTER the prologue: a border tap reads 0, not ``relu(b)``), then
  the statistics;
* ``run_mm`` (``tools/exp_conv_bn2.py:55``, ``:67``, bodies ``_k_mm`` and,
  with ``kern=_k_stat, nstat=True``, ``_k_stat``) and ``run_pro``
  (``:80``, ``:85``, body ``_k_pro``): kernel 11 split into its parts.

All five bodies run on two kernels written for Hopper in
``csrc/conv_wgmma.cuh`` (design in ``csrc/conv_bn.cu``'s header):
``conv1x1_wgmma`` (every 1x1 body) and ``conv3x3_wgmma`` (the 3x3 as an
implicit GEMM over shifted rows of the flat NHWC image), one persistent
``wgmma`` + TMA template: a TMA producer thread feeds x's and W's K slices
through an mbarrier ring, consumer warpgroups multiply with W read in
place as an MN-major operand, and y leaves by TMA stores.  The prologue
runs in place in shared memory where each x element meets it once (a 1x1
of one column tile), else in one pass before the GEMM
(``conv_bn_prologue``), and the 3x3's taps outside the image are zeroed
by spare producer warps.  A 3x3 whose C is not a multiple of 64 takes the
kept ``mma.sync`` kernel instead.  :func:`conv_plan` is the shape rule
(route, tile, prologue), never a failed build or launch.  The
statistics are per-block column sums of the f32 accumulator, added by a
fixed-order column sum (no atomics, so they repeat bitwise).  The
semantics kept from the scripts: the prologue runs in f32 and rounds to
x's type before the product; the statistics come from the f32
accumulator, not the rounded ``y``; ragged rows are masked; a 3x3 tap
outside the image reads 0 after the prologue.  The layouts are the
scripts': ``x2 [M, K]``, ``w [K, N]``, ``s, b [K]`` f32; NHWC ``x`` with
an HWIO ``w``.  A paddle 1x1 conv weight ``[N, K, 1, 1]`` is handed in as
``w.reshape(N, K).t().contiguous()``.

The TPU tile arguments (``bm``, ``bn``, ``bn_blk``, ``bc``) are taken and
ignored, except where they change the result: a shape the JAX function
would refuse (``run_mm``'s ``M % bm``, ``fused3x3``'s ``n % bn_blk`` and
``Co % bc``) or leave partly unwritten (the floored column grids of
``fused_conv1x1_bn`` and ``run_pro``, the floored row grid of ``run_pro``)
raises ``ValueError``.  None of the kernels has a backward (nor has any
in the reference).  No path of the port calls them: the port's ResNet,
like the reference's, convolves through ``nn.functional.conv2d``.

``chain_1x1`` and ``chain_3x3`` are the scripts' ``xla_chain``: batch-norm
apply, relu, the product or conv in bf16 through PyTorch, and statistics
of the rounded output.  They are the yardstick a caller times as the
library call; nothing in the port calls them either.

CPU tensors take the plain versions (``*_plain``); CUDA tensors launch the
kernels or raise.  Launch counters: ``fused_conv1x1_bn.launches``,
``fused3x3.launches``, ``run_mm.launches`` (both bodies; each body's
own in ``run_mm.launches_mm`` and ``run_mm.launches_stat``),
``run_pro.launches``, ``conv_bn_column_sum.launches`` (the statistics'
second stage) and ``conv_bn_prologue.launches`` (the prologue pass); by
route, ``launches_wgmma`` on the four entry points and
``fused3x3.launches_mma`` (the kept ``mma.sync`` kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .flash_attention import _on_card

__all__ = ["fused_conv1x1_bn", "fused3x3", "run_mm", "run_pro",
           "conv_bn_column_sum", "fused_conv1x1_bn_plain", "fused3x3_plain",
           "run_mm_plain", "run_pro_plain", "chain_1x1", "chain_3x3",
           "conv1x1_cost", "conv3x3_cost", "conv_plan", "conv_bn_prologue"]

# ``run_mm``'s ``kern`` argument: which Pallas body (and CUDA instance)
_k_mm = "mm"
_k_stat = "stat"

_MMA_BM = 128   # rows of the mma.sync kernel's tile (csrc/conv_bn.cu)
_WG_BN = (64, 128, 256)   # the wgmma kernel's column tiles


# -- plain versions ------------------------------------------------------------

def _prologue(x, s, b):
    """``relu(x * s + b)`` in f32, rounded to x's type."""
    return torch.relu(x.float() * s.float() + b.float()).to(x.dtype)


def _col_stats(acc):
    """``[sum, sum of squares]`` over the rows of the f32 ``[M, N]``."""
    return torch.stack([acc.sum(dim=0), (acc * acc).sum(dim=0)])


def run_mm_plain(x2, w, stats=False):
    """``x2 @ w`` in f32 over the operands, rounded to x's type; with
    ``stats`` also the f32 ``[2, N]`` statistics of the f32 product."""
    acc = torch.matmul(x2.float(), w.float())
    y = acc.to(x2.dtype)
    return (y, _col_stats(acc)) if stats else y


def run_pro_plain(x2, s, b, w):
    """``relu(x2 * s + b)`` rounded to x's type, then ``@ w``."""
    return run_mm_plain(_prologue(x2, s, b), w)


def fused_conv1x1_bn_plain(x2, s, b, w):
    """The prologue, the product and the statistics: ``(y, stats)``."""
    return run_mm_plain(_prologue(x2, s, b), w, stats=True)


def fused3x3_plain(x, s, b, w):
    """NHWC ``x``, HWIO ``w``: the prologue, zero padding after it, the
    3x3 conv in f32 over the rounded operands, ``(y, stats)``."""
    xn = _prologue(x, s, b).float().permute(0, 3, 1, 2)
    acc = tF.conv2d(xn, w.float().permute(3, 2, 0, 1), padding=1)
    acc = acc.permute(0, 2, 3, 1).contiguous()
    return acc.to(x.dtype), _col_stats(acc.reshape(-1, acc.shape[-1]))


def chain_1x1(x2, s, b, w):
    """``exp_conv_bn.xla_chain``: the prologue, ``torch.matmul`` in x's
    type, the mean and variance of the rounded ``y``: ``(y, mean, var)``."""
    y = torch.matmul(_prologue(x2, s, b), w)
    yf = y.float()
    mean = yf.mean(dim=0)
    var = torch.clamp((yf * yf).mean(dim=0) - mean * mean, min=0)
    return y, mean, var


def chain_3x3(x, s, b, w):
    """``exp_conv3x3.xla_chain``: the prologue, ``conv2d`` in x's type
    (NHWC memory, SAME), the sums of the rounded ``y``: ``(y, sum,
    sumsq)``."""
    xn = _prologue(x, s, b).permute(0, 3, 1, 2)
    y = tF.conv2d(xn, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    yf = y.float()
    return y, yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def conv1x1_cost(M, K, N, prologue=True, stats=True):
    """Analytic work of one 1x1 call: (flops, bytes).  Flops count the
    product at 2 a multiply-add; bytes count bf16 x, w and y once each,
    the f32 scale and shift once (prologue) and the f32 statistics written
    once (stats)."""
    return (2.0 * M * K * N,
            2.0 * (M * K + K * N + M * N) + (8.0 * K if prologue else 0.0)
            + (8.0 * N if stats else 0.0))


def conv3x3_cost(n, H, W, C, Co):
    """Analytic work of one ``fused3x3``: (flops, bytes), ``2 n H W 9C Co``
    flops; bf16 x, w and y and the f32 scale, shift and statistics moved
    once."""
    M = n * H * W
    return (2.0 * M * 9 * C * Co,
            2.0 * (M * C + 9 * C * Co + M * Co) + 8.0 * C + 8.0 * Co)


# -- shape rules of the reference ----------------------------------------------

def _mat_shapes(x2, w, what, s=None, b=None):
    if x2.dim() != 2 or w.dim() != 2 or w.shape[0] != x2.shape[1]:
        raise ValueError(f"{what} takes x2 [M, K] and w [K, N], got "
                         f"{tuple(x2.shape)} and {tuple(w.shape)}")
    M, K = x2.shape
    if M == 0:
        raise ValueError(f"{what}: M = 0 rows (the reference's tile is empty)")
    for p in (s, b):
        if p is not None and tuple(p.shape) != (K,):
            raise ValueError(f"{what} takes s and b of shape [{K}], got "
                             f"{tuple(p.shape)}")
    return M, K, w.shape[1]


def _whole_tiles(size, tile, axis, what):
    """The reference's floored grid: a size that is not a whole number of
    (clamped) tiles would leave its tail unwritten."""
    tile = min(tile, size)
    if tile <= 0 or size % tile:
        raise ValueError(f"{what}: {axis} = {size} is not a whole number of "
                         f"{tile}-wide tiles; the reference would leave the "
                         f"tail unwritten or refuse")


# -- kernel launches -----------------------------------------------------------

def conv_plan(M, N, C=None, sms=132, prologue=True):
    """The kernel and tile of one launch, a pure function of the shape:
    ``dict(route, bm, bn, nwg, groups, prologue)``.  ``C`` is the 3x3's
    input channels (None for a 1x1); ``sms`` the card's multiprocessor
    count; ``prologue``: whether the call applies one.

    * ``route="wgmma"`` for every 1x1 and every 3x3 with ``C % 64 == 0``
      (a tap's 64-wide K slice must not straddle two taps).  ``bn``: the
      narrowest of 64, 128, 256 that holds N, halved while that leaves
      fewer than ``sms / 2`` tiles of 128 rows (a wider tile passes each
      element of x through the prologue fewer times, and each slice's
      fixed cost buys more products: on the H100, 98 tiles of 128 x 256
      took 0.0254 ms at M=12544 K=1024 N=256, 196 of 128 x 128 0.0374,
      ``tools/conv_bn_sweep.py``); ``bm`` 128 (``nwg`` = 2 consumer
      warpgroups, one block an SM), or 64 (``nwg`` = 1, two blocks an SM)
      where 128 x 64 tiles are still fewer than ``sms / 2``.
    * ``route="mma"``: the kept ``mma.sync`` kernel, 128 x 128 tiles (128
      x 64 when N <= 64).

    ``groups``: blocks along M, each walking the row tiles g, g + groups,
    ... of its column tile (the statistics' partials are ``[2, groups,
    N]``): as many as fill the card's blocks over the column tiles, at
    most one a row tile.

    ``prologue`` (wgmma route): ``"kernel"`` where each x element meets
    the prologue once (a 1x1 of one column tile: in place in shared
    memory, as its slice lands), ``"pass"`` where the kernel would repeat
    it (the 3x3's nine taps, a 1x1 of several column tiles): one pass
    writes ``relu(x * s + b)`` (``conv_bn_prologue``), the kernel reads
    that and the 3x3 zeroes its taps outside the image.  The in-place
    prologue costs a shared-memory load and store of the tile on every
    slice, beside TMA's write and wgmma's read: on the H100 at M=3136
    K=2048 N=512 (four column tiles) 0.0359 ms, against 0.0068 for the
    pass and 0.0155 for the product after it; at M=12544 K=1024 N=256
    (one) 0.0254, against 0.0183 + 0.0178 (``tools/conv_bn_sweep.py``).
    None without a prologue or on the mma route."""
    def cdiv(a, b):
        return -(-a // b)

    if C is not None and C % 64:
        bm, bn, nwg, occ = _MMA_BM, 64 if N <= 64 else 128, None, 2
        route = "mma"
    else:
        bn = min(t for t in _WG_BN if t >= min(N, 256))
        while bn > 64 and 2 * cdiv(M, 128) * cdiv(N, bn) < sms:
            bn //= 2
        bm = 128 if 2 * cdiv(M, 128) * cdiv(N, bn) >= sms else 64
        nwg, occ, route = bm // 64, 2 if bm == 64 else 1, "wgmma"
    col_tiles, row_tiles = cdiv(N, bn), cdiv(M, bm)
    groups = max(1, min(row_tiles, occ * sms // col_tiles, 65535))
    pro = None
    if route == "wgmma" and (prologue or C is not None):
        pro = "pass" if C is not None or col_tiles > 1 else "kernel"
    return dict(route=route, bm=bm, bn=bn, nwg=nwg, groups=groups,
                prologue=pro)


_SMS: dict = {}


def _sms(dev):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check_dev(what, x, w, s=None, b=None, C=None):
    """What the CUDA kernel reads: bf16 x and w, contiguous and 16-byte
    aligned, the channel counts multiples of 8; f32 contiguous s and b;
    one device."""
    for t, name in ((x, "x"), (w, "w")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the {what} kernel takes bfloat16 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the {what} kernel reads {name} with 16-byte "
                             f"loads: it must be contiguous and 16-byte "
                             f"aligned, got strides {t.stride()}")
    K = x.shape[-1] if C is None else C
    if K % 8 or w.shape[-1] % 8:
        raise ValueError(f"the {what} kernel takes channel counts that are "
                         f"multiples of 8, got {K} in and {w.shape[-1]} out")
    for p in (s, b):
        if p is not None and (p.dtype != torch.float32
                              or not p.is_contiguous()):
            raise TypeError(f"the {what} kernel takes contiguous float32 s "
                            f"and b, got {p.dtype}")
    if any(t is not None and t.device != x.device for t in (w, s, b)):
        raise ValueError(f"{what}'s operands must lie on one device")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def conv_bn_column_sum(part):
    """``[2, N]`` f32 column sums of the kernels' ``[2, groups, N]`` f32
    partials, each column added in block order (CUDA tensors only)."""
    from . import _build

    _, groups, N = part.shape
    stats = torch.empty(2, N, dtype=torch.float32, device=part.device)
    err = _build.library().paddle_conv_bn_colsum(
        part.data_ptr(), stats.data_ptr(), groups, N, _stream(part))
    _build.check(err, "conv_bn_column_sum")
    conv_bn_column_sum.launches += 1
    return stats


def conv_bn_prologue(x, s, b):
    """``relu(x * s + b)`` in f32, rounded to bf16, over the channels (the
    last axis) of a bf16 ``x``: the wgmma route's prologue pass (CUDA
    tensors only)."""
    from . import _build

    out = torch.empty_like(x)
    C = x.shape[-1]
    rows = x.numel() // C
    blocks = max(1, min(-(-x.numel() // 2048), 8 * _sms(x.device)))
    err = _build.library().paddle_conv_bn_prologue(
        x.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), rows, C,
        blocks, _stream(x))
    _build.check(err, "conv_bn_prologue")
    conv_bn_prologue.launches += 1
    return out


def _launch(what, x, s, b, w, M, K, N, stats, hwc=(0, 0, 0)):
    """One GEMM launch on the route of :func:`conv_plan` (after the
    prologue pass, where the plan takes one; and the column sum under
    ``stats``): ``(y [M, N] bf16 (and the [2, N] f32 statistics),
    route)``."""
    from . import _build

    lib = _build.library()
    H, W, C = hwc
    plan = conv_plan(M, N, C or None, _sms(x.device), s is not None)
    y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
    part = (torch.empty(2, plan["groups"], N, dtype=torch.float32,
                        device=x.device) if stats else None)
    pro = int(s is not None)
    if plan["prologue"] == "pass":
        x, pro = conv_bn_prologue(x, s, b), 2 if C else 0
    args = (x.data_ptr(), None if s is None else s.data_ptr(),
            None if b is None else b.data_ptr(), w.data_ptr(), y.data_ptr(),
            None if part is None else part.data_ptr(), M, K, N, H, W, C,
            pro, int(stats), int(C > 0))
    if plan["route"] == "wgmma":
        err = lib.paddle_conv_bn_wgmma(*args, plan["bn"], plan["nwg"],
                                       plan["groups"], _stream(x))
    else:
        err = lib.paddle_conv_bn_gemm(*args, plan["groups"], _stream(x))
    _build.check(err, what)
    out = (y, conv_bn_column_sum(part)) if stats else y
    return out, plan["route"]


def _count(fn, route):
    fn.launches += 1
    if route == "wgmma":
        fn.launches_wgmma += 1
    else:
        fn.launches_mma += 1


# -- public entry points -------------------------------------------------------

def fused_conv1x1_bn(x2, s, b, w, bm=1024, bn=512):
    """x2 ``[M, K]`` (the previous conv's raw output), s and b ``[K]`` f32
    (its batch-norm scale and shift), w ``[K, N]``: ``(y [M, N], stats [2,
    N] f32)``.  Any M; N must be a whole number of ``min(bn, N)`` tiles."""
    M, K, N = _mat_shapes(x2, w, "fused_conv1x1_bn", s, b)
    _whole_tiles(N, bn, "N", "fused_conv1x1_bn")
    if not _on_card(x2, "fused_conv1x1_bn"):
        return fused_conv1x1_bn_plain(x2, s, b, w)
    _check_dev("fused_conv1x1_bn", x2, w, s, b)
    out, route = _launch("fused_conv1x1_bn", x2, s, b, w, M, K, N,
                         stats=True)
    _count(fused_conv1x1_bn, route)
    return out


def fused3x3(x, s, b, w, bn_blk=8, bc=None):
    """NHWC x ``[n, H, W, C]``, s and b ``[C]`` f32, HWIO w ``[3, 3, C,
    Co]``: ``(y [n, H, W, Co], stats [2, Co] f32)``.  ``n`` must be a whole
    number of ``min(bn_blk, n)`` images and ``Co`` of ``bc`` columns, as
    the reference asserts."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                             x.shape[3]):
        raise ValueError(f"fused3x3 takes NHWC x and HWIO w [3, 3, C, Co], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    n, H, W, C = x.shape
    Co = w.shape[3]
    for p in (s, b):
        if tuple(p.shape) != (C,):
            raise ValueError(f"fused3x3 takes s and b of shape [{C}], got "
                             f"{tuple(p.shape)}")
    if n == 0 or H == 0 or W == 0:
        raise ValueError(f"fused3x3: empty image batch {tuple(x.shape)}")
    _whole_tiles(n, bn_blk, "n", "fused3x3")
    _whole_tiles(Co, bc or Co, "Co", "fused3x3")
    if not _on_card(x, "fused3x3"):
        return fused3x3_plain(x, s, b, w)
    _check_dev("fused3x3", x, w, s, b, C=C)
    (y, st), route = _launch("fused3x3", x, s, b, w, n * H * W, 9 * C, Co,
                             stats=True, hwc=(H, W, C))
    _count(fused3x3, route)
    return y.view(n, H, W, Co), st


def run_mm(x2, w, bm=1024, bn=512, kern=_k_mm, nstat=False):
    """``x2 @ w`` (body ``_k_mm``) or, with ``kern=_k_stat, nstat=True``,
    ``(x2 @ w, stats)`` (body ``_k_stat``).  M and N must be whole numbers
    of ``min(bm, M)`` and ``min(bn, N)`` tiles."""
    if (kern, bool(nstat)) not in ((_k_mm, False), (_k_stat, True)):
        raise ValueError("run_mm takes kern=_k_mm with nstat=False or "
                         "kern=_k_stat with nstat=True, as the reference's "
                         "bodies take their outputs")
    M, K, N = _mat_shapes(x2, w, "run_mm")
    _whole_tiles(M, bm, "M", "run_mm")
    _whole_tiles(N, bn, "N", "run_mm")
    if not _on_card(x2, "run_mm"):
        return run_mm_plain(x2, w, stats=nstat)
    _check_dev("run_mm", x2, w)
    out, route = _launch("run_mm", x2, None, None, w, M, K, N, stats=nstat)
    _count(run_mm, route)
    if nstat:
        run_mm.launches_stat += 1
    else:
        run_mm.launches_mm += 1
    return out


def run_pro(x2, s, b, w, bm=1024, bn=512):
    """``relu(x2 * s + b) @ w`` (body ``_k_pro``).  M and N must be whole
    numbers of ``min(bm, M)`` and ``min(bn, N)`` tiles."""
    M, K, N = _mat_shapes(x2, w, "run_pro", s, b)
    _whole_tiles(M, bm, "M", "run_pro")
    _whole_tiles(N, bn, "N", "run_pro")
    if not _on_card(x2, "run_pro"):
        return run_pro_plain(x2, s, b, w)
    _check_dev("run_pro", x2, w, s, b)
    out, route = _launch("run_pro", x2, s, b, w, M, K, N, stats=False)
    _count(run_pro, route)
    return out


for _fn in (fused_conv1x1_bn, fused3x3, run_mm, run_pro):
    _fn.launches = 0
    _fn.launches_wgmma = 0
fused3x3.launches_mma = 0
run_mm.launches_mm = 0
run_mm.launches_stat = 0
conv_bn_column_sum.launches = 0
conv_bn_prologue.launches = 0
