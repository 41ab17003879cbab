"""The Python side of the bf16 tensor-core flash kernels, on the CPU.

The kernels read every bf16 operand through a 4-D TMA tensor map built per
call from the operand's strides (``encode_map`` in ``csrc/sm90.cuh``);
``_tma_layout`` computes the same map and raises, before any launch, on
what TMA cannot read.  These tests hold that helper, the output-alignment
check, the CPU route of the backward (no launch, delta included) and the
smoke script's kernel-name helper.  No JAX here: nothing of it is needed.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import flash_attention as fa


def test_tma_layout_of_the_fused_role_views():
    """The fused [B, T, nh, 3, hd] projection's role views: head stride
    384 bytes, sequence stride 4608, read in place; k and v start 128 and
    256 bytes past q."""
    B, T = 2, 40
    qkv = torch.zeros(B, T, 12, 3, 64, dtype=torch.bfloat16)
    q, k, v = fa._split_qkv(qkv)
    for x in (q, k, v):
        dims, strides, order = fa._tma_layout(x, "q")
        assert dims == (64, 12, T, B)
        assert strides == (384, 4608, T * 4608)
        assert order == ("h", "t", "b")
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == \
        (128, 256)


def test_tma_layout_orders_the_outer_dims_by_stride():
    """A contiguous [B, T, H, D] operand keeps (h, t, b); a [B, H, T, D]
    buffer viewed as [B, T, H, D] puts the sequence first."""
    x = torch.zeros(2, 40, 12, 64, dtype=torch.bfloat16)
    assert fa._tma_layout(x, "k") == ((64, 12, 40, 2),
                                      (128, 1536, 61440), ("h", "t", "b"))
    y = torch.zeros(2, 12, 40, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa._tma_layout(y, "k") == ((64, 40, 12, 2),
                                      (128, 5120, 61440), ("t", "h", "b"))


def test_tma_layout_puts_size_one_dims_last():
    """Size-1 dims go last, in (h, t, b) order, with the extent of the
    dims before them as their stride (whatever torch reports)."""
    x = torch.zeros(1, 40, 1, 64, dtype=torch.bfloat16)
    assert fa._tma_layout(x, "v") == ((64, 40, 1, 1), (128, 5120, 5120),
                                      ("t", "h", "b"))
    one = torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16)
    assert fa._tma_layout(one, "v") == ((32, 1, 1, 1), (64, 64, 64),
                                        ("h", "t", "b"))


def test_tma_layout_raises_on_what_tma_cannot_read():
    x = torch.zeros(2, 40, 3, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="head stride is 136 bytes"):
        fa._tma_layout(x, "q")
    flat = torch.zeros(2 * 40 * 3 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="base address"):
        fa._tma_layout(flat[1:].view(2, 40, 3, 64), "k")
    seq = torch.zeros(2, 41, 3, 64, dtype=torch.bfloat16)[:, :40]
    assert fa._tma_layout(seq, "v")[1] == (128, 384, 41 * 384)
    odd = torch.zeros(2, 40, 1, 72, dtype=torch.bfloat16)[..., 4:68]
    with pytest.raises(ValueError, match="base address"):
        fa._tma_layout(odd, "v")
    with pytest.raises(ValueError, match="unit-stride"):
        fa._tma_layout(torch.zeros(2, 40, 3, 128,
                                   dtype=torch.bfloat16)[..., ::2], "q")


def test_outputs_take_16_byte_rows():
    """The epilogue writes 16 bytes a thread: the dqkv role slices pass,
    a misaligned base or stride raises, and ``_check_bf16`` runs both
    checks."""
    dqkv = torch.zeros(2, 40, 12, 3, 64, dtype=torch.bfloat16)
    for g in fa._split_qkv(dqkv):
        fa._rows16(g, "dq")
    bad = torch.zeros(2, 40, 12, 3, 66, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte rows"):
        fa._rows16(bad[:, :, :, 0], "dk")
    q = torch.zeros(2, 40, 12, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dv in 16-byte rows"):
        fa._check_bf16(((q, "q"),), ((bad[:, :, :, 1], "dv"),))
    fa._check_bf16(((q, "q"),), ((q, "out"),))


def test_backward_on_cpu_takes_plain_without_a_launch():
    """CPU tensors take the plain backward: no delta, dk/dv or dq launch
    is counted, on either wrapper."""
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.randn(1, 16, 2, 3, 32).astype(np.float32))
    do = torch.from_numpy(rs.randn(1, 16, 64).astype(np.float32))
    counters = [(f, a) for f in (fa.flash_attention_bwd,
                                 fa.flash_attention_qkv_fused_bwd)
                for a in ("launches_delta", "launches_dkv", "launches_dq")]
    before = [getattr(f, a) for f, a in counters]
    out, lse = fa.flash_attention_qkv_fused_plain(qkv, return_lse=True)
    got = fa.flash_attention_qkv_fused_bwd(qkv, out, lse, do)
    torch.testing.assert_close(got, fa.flash_attention_qkv_fused_bwd_plain(
        qkv, out, lse, do))
    q, k, v = fa._split_qkv(qkv)
    sep = fa.flash_attention_bwd(q, k, v, out.view(1, 16, 2, 32), lse,
                                 do.view(1, 16, 2, 32))
    for g, w in zip(sep, got.unbind(3)):
        torch.testing.assert_close(g, w)
    assert [getattr(f, a) for f, a in counters] == before


@pytest.mark.parametrize("mangled,name", [
    ("_ZN55_GLOBAL__N__8f45d1f5_22_flash_attention_bwd_cu_5c0e3b0325"
     "flash_bwd_dkv_bf16_kernelILi64EEEvNS_11Bf16BwdArgsE",
     "flash_bwd_dkv_bf16_kernel<64>"),
    ("_ZN55_GLOBAL__N__8f45d1f5_22_flash_attention_bwd_cu_5c0e3b0319"
     "flash_bwd_dq_kernelIfLi128EEEvNS_7BwdArgsIT_EE",
     "flash_bwd_dq_kernel<float,128>"),
    ("_ZN55_GLOBAL__N__8f45d1f5_22_flash_attention_bwd_cu_5c0e3b0322"
     "flash_bwd_delta_kernelI13__nv_bfloat16Lb1EEEvPKT_N12paddle_flash7"
     "StridesES4_S6_Pfiiii", "flash_bwd_delta_kernel<bf16,1>"),
    ("_Z3foov", "_Z3foov")])
def test_smoke_names_the_kernels_it_counts(mangled, name):
    """Phase 2's HGMMA print names each flash kernel by its template."""
    assert chip_smoke._kernel_name(mangled) == name
