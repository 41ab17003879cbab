"""Paged decode attention: a CUDA kernel for Hopper beside its plain
PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/kernels/paged_attention.py``
``paged_decode_attention`` -> ``_decode_kernel``, the serving decode read
of the paged KV pool.  The kernel is ``csrc/paged_attention.cu``, split
over pages: a block of the chunk kernel takes one row's chunk of
consecutive positions (whole pages, or a divisor of a long page) for one
head, moves its K and V into shared memory with TMA boxes that
are all in flight at once, and writes the chunk's softmax max, sum and
unnormalised ``o`` to a workspace; a merge kernel combines a row's chunks
by the log-sum-exp rule in chunk order.  The result is the whole-row f32
softmax regrouped: only the rounding differs from the plain
gather-then-softmax read (well inside the 1e-4 the tests hold it to), and
a call repeats bit for bit.  Chunks at or past
``start + W`` are never loaded, so bytes scale with the resident tokens;
the grid comes from the shapes alone (:func:`paged_plan`) and the kernel
finds the live chunks itself, so a launch never syncs and can be captured
in a CUDA graph.  No table is too wide: the row's scores never sit in one
block.

What bounds it on the H100: bytes.  About 0.5 flop per pool byte at W=1
f32, far below the ridge; :func:`paged_cost` counts the bytes the row's
resident tokens need.

:func:`paged_decode_attention` picks the plain version for CPU tensors
only; for CUDA tensors it launches the kernels or raises.  Every call
adds one to ``paged_decode_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_cost", "paged_plan", "MAX_W"]

NEG_INF = -1e30
MAX_W = 8                  # widest query span the kernel takes (kMaxW)
CHUNK_POSITIONS = 64       # positions a chunk block reads, at most


@functools.lru_cache(maxsize=256)
def paged_plan(B, W, H, D, P, n_pt, chunk_positions=CHUNK_POSITIONS) -> dict:
    """The launch of one call, from the shapes alone (never from
    ``lengths``, so it needs no sync and is the same for every step of an
    engine); a block reads one head:

    * ``segment``: positions one TMA box (a stage with its own mbarrier)
      holds, never crossing a page: the page, or for pages longer than
      ``chunk_positions`` the largest divisor of ``P`` not above it;
    * ``chunk``: positions a block reads, ``segments * segment`` (at most
      ``chunk_positions``, which the kernel caps at 64), and ``n_chunks``
      of them cover a row;
    * ``grid``: ``(B * H * n_chunks,)`` chunk blocks, one for every (row,
      chunk, head) item the shapes allow: block i takes the i-th live item
      (those below a row's ``start + W``, counted in the kernel from
      ``lengths``), so the live items are the grid's first blocks and
      spread over the SMs; the rest exit at once;
    * ``workspace_bytes``: the f32 partial outputs ``[B, n_chunks, H, W,
      D]`` and chunk max and sum ``[2, B, n_chunks, H, W]``.

    Cached: an engine asks for the same plan every decode step (the dict
    is shared; do not change it).
    """
    if P <= chunk_positions:
        segment = P
    else:
        segment = max(d for d in range(1, chunk_positions + 1) if P % d == 0)
    segments = max(1, min(32, min(chunk_positions, n_pt * P) // segment))
    chunk = segments * segment
    n_chunks = -(-n_pt * P // chunk)
    return dict(grid=(B * H * n_chunks,), segment=segment, segments=segments,
                chunk=chunk, n_chunks=n_chunks,
                workspace_bytes=4 * B * n_chunks * H * W * (D + 2))


def _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q is [B, W, H, D] and the pools [NP, P, H, D]")
    B, W, H, D = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (H, D):
        raise ValueError(f"pool shapes {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError("page_table is [B, n_pt] and lengths [B]")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != \
            (v_scale is None):
        raise ValueError("int8 pools need k_scale/v_scale and f32 pools "
                         f"must not pass them (pool {k_pages.dtype}, "
                         f"k_scale={'set' if k_scale is not None else None})")
    if quant and (k_scale.shape != k_pages.shape[:2] or
                  v_scale.shape != v_pages.shape[:2]):
        raise ValueError("k_scale/v_scale are [NP, P]")
    return quant


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                                 k_scale=None, v_scale=None, scale=None):
    """The plain version: gather every row's pages into a ``[B, virt, H,
    D]`` view (sentinels clipped to a real page), dequantize, mask
    ``col <= start + row`` with -1e30, f32 softmax, ``@ V`` — the XLA read
    of ``paddle_tpu/models/gpt.py``'s paged branch."""
    quant = _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    B, W, H, D = q.shape
    NP, P = k_pages.shape[:2]
    n_pt = page_table.shape[1]
    virt = n_pt * P
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    pt_safe = page_table.long().clamp(0, NP - 1)
    k_att = k_pages[pt_safe].reshape(B, virt, H, D)
    v_att = v_pages[pt_safe].reshape(B, virt, H, D)
    if quant:
        k_att = k_att.to(q.dtype) * \
            k_scale[pt_safe].reshape(B, virt)[..., None, None].to(q.dtype)
        v_att = v_att.to(q.dtype) * \
            v_scale[pt_safe].reshape(B, virt)[..., None, None].to(q.dtype)
    else:
        k_att, v_att = k_att.to(q.dtype), v_att.to(q.dtype)
    cols = lengths.long()[:, None] + torch.arange(W, device=q.device)[None]
    mask = torch.arange(virt, device=q.device)[None, None, :] <= \
        cols[:, :, None]                                   # [B, W, virt]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k_att, v_att))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale     # [B, H, W, virt]
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def paged_cost(lengths, W, H, D, P, n_pt, quant):
    """Analytic work of one call: (flops, bytes) for the tokens each row
    really holds — ``min(start + W, n_pt*P)`` positions for a live row,
    none for a parked one.  Bytes: those positions' K and V (int8 pools:
    1 byte each plus an f32 scale per position), q in and out in f32,
    and the row's page-table entries and length."""
    virt = n_pt * P
    flops = 0.0
    nbytes = 0.0
    esize = 1 if quant else 4
    for start in (int(x) for x in lengths):
        nbytes += 4 * (n_pt + 1) + 2 * 4 * W * H * D
        if start >= virt:
            continue
        live = min(virt, start + W)
        flops += 4.0 * H * W * live * D
        nbytes += 2.0 * live * H * D * esize + (2.0 * live * 4 if quant
                                                else 0.0)
    return flops, nbytes


def _launch(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale,
            scale, quant, plan=None):
    """Launch the kernels on CUDA tensors, under ``plan`` (default: the
    :func:`paged_plan` of the shapes; ``tools/paged_sweep.py`` passes
    others)."""
    from . import _build

    B, W, H, D = q.shape
    NP, P = k_pages.shape[:2]
    n_pt = page_table.shape[1]
    if q.dtype != torch.float32:
        raise TypeError(f"the paged kernel takes float32 q, got {q.dtype}")
    if k_pages.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"the paged kernel takes f32 or int8 pools, got "
                        f"{k_pages.dtype}")
    if D not in (32, 64, 128):
        raise ValueError(f"the paged kernel takes head size 32, 64 or 128, "
                         f"got {D}")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"the paged kernel takes 1 <= W <= {MAX_W}, got {W}")
    tensors = [q, k_pages, v_pages, page_table, lengths] + \
        ([k_scale, v_scale] if quant else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on q's device")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the TMA copies need 16-byte aligned pools")
    page_table = page_table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if quant:
        k_scale = k_scale.float().contiguous()
        v_scale = v_scale.float().contiguous()
    if plan is None:
        plan = paged_plan(B, W, H, D, P, n_pt)
    n_chunks = plan["n_chunks"]
    lib = _build.library()
    out = torch.empty_like(q)
    # the workspace: partial outputs, then the chunks' max and sum
    work = torch.empty(plan["workspace_bytes"] // 4, device=q.device)
    part_o = work.data_ptr()
    # the raw handle: a decode step makes 12 calls, and building a
    # torch.cuda.Stream object costs several µs of each
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = lib.paddle_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_o, part_o + 4 * B * n_chunks * H * W * D,
        B, W, H, D, P, n_pt, NP, plan["segment"], plan["segments"],
        n_chunks, ctypes.c_float(scale), int(quant), stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           k_scale=None, v_scale=None, scale=None):
    """Paged attention read for per-slot decode.

    Args:
        q: ``[B, W, H, D]`` queries at positions ``start .. start+W-1``.
        k_pages / v_pages: ``[NP, P, H, D]`` pools, f32 or int8, already
            holding this step's writes.
        page_table: ``[B, n_pt]`` int32; entries ``>= NP`` are sentinels.
        lengths: ``[B]`` int32 start positions (parked rows sit at
            ``n_pt * P``; their output is never read).
        k_scale / v_scale: ``[NP, P]`` f32, required iff the pools are int8.

    Returns ``[B, W, H, D]``.  CPU tensors take
    :func:`paged_decode_attention_plain`; CUDA tensors launch the kernels.
    """
    quant = _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, k_scale, v_scale, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    return _launch(q, k_pages, v_pages, page_table, lengths, k_scale,
                   v_scale, float(scale), quant)


paged_decode_attention.launches = 0
