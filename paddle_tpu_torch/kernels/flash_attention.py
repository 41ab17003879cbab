"""Flash-attention forward: a CUDA kernel for Hopper beside its plain
PyTorch version.

Replaces the Pallas TPU kernel ``paddle_tpu/kernels/flash_attention.py``
``_flash_fwd`` -> ``_fwd_kernel`` (reached through ``flash_attention_bthd``).
The kernel is ``csrc/flash_attention_fwd.cu``: one block per (b*h, 64-row
q tile) with an in-block online-softmax loop over K/V tiles staged in
shared memory, f32 FMAs throughout.  The TPU kernel's one-pass ``nk == 1``
branch was a VMEM-size choice and is not carried over.

What bounds it on the H100: at D = 64 and prompts of a few hundred tokens
the arithmetic (4*Tq*Tk*D flops per head) is above the f32 ridge, so
operations bound it — the f32 FMA pipe without tensor cores, fed from
shared memory.  ``flash_cost`` gives the analytic flops and bytes.

:func:`flash_attention_bthd` picks the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.  Every launch adds one
to ``flash_attention_bthd.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention_bthd", "flash_attention_plain", "flash_cost",
           "sdpa_ref", "NEG_INF"]

NEG_INF = -1e30


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


def sdpa_ref(q, k, v, mask, causal, scale):
    """``_sdpa_ref`` of the JAX package (inference: no dropout) on
    ``[B, T, H, D]``: scores, f32 softmax, ``@ v``.  ``mask`` is broadcast
    against ``[B, H, Tq, Tk]``."""
    probs = torch.softmax(_scores(q, k, mask, causal, scale), dim=-1)
    return torch.matmul(probs.to(q.dtype), v.transpose(1, 2)).transpose(1, 2)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] q, k and v")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention_plain(q, k, v, causal=True, scale=None,
                          return_lse=False):
    """The plain version: :func:`sdpa_ref` without a mask, and the f32
    logsumexp ``[B*H, Tq, 1]`` of the same scores."""
    _check(q, k, v)
    B, Tq, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = sdpa_ref(q, k, v, None, causal, scale)
    if not return_lse:
        return out
    lse = torch.logsumexp(_scores(q, k, None, causal, scale), dim=-1)
    return out, lse.reshape(B * H, Tq, 1)


def flash_cost(B, Tq, Tk, H, D, causal=True):
    """Analytic work of one call: (flops, bytes).  Flops count QK^T and
    PV (2 flops per multiply-add) over the live (causal) pairs; bytes
    count q, k and v read once and out and lse written once, in f32."""
    if causal:
        off = Tk - Tq
        pairs = sum(max(0, min(Tk, r + off + 1)) for r in range(Tq))
    else:
        pairs = Tq * Tk
    flops = 4.0 * B * H * pairs * D
    nbytes = 4.0 * (2 * B * Tq * H * D + 2 * B * Tk * H * D + B * H * Tq)
    return flops, nbytes


def _launch(q, k, v, causal, scale):
    from . import _build

    if q.dtype != torch.float32 or k.dtype != torch.float32 or \
            v.dtype != torch.float32:
        raise TypeError("the flash kernel takes float32 q, k and v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    lib = _build.library()
    if lib.paddle_flash_attention_smem_bytes(D) == 0:
        raise ValueError(f"the flash kernel takes head size 32, 64 or 128, "
                         f"got {D}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B * H, Tq, 1, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paddle_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Tq, Tk, H, D, ctypes.c_float(scale),
        int(bool(causal)), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_bthd.launches += 1
    return out, lse


def flash_attention_bthd(q, k, v, causal=True, scale=None, return_lse=False):
    """Attention in the fused-op layout: q ``[B, Tq, H, D]``, k and v
    ``[B, Tk, H, D]``; returns out (shape of q) and, with ``return_lse``,
    the f32 logsumexp ``[B*H, Tq, 1]`` the backward will need.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch
    the kernel (any failure raises)."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    out, lse = _launch(q, k, v, causal, float(scale))
    return (out, lse) if return_lse else out


flash_attention_bthd.launches = 0
