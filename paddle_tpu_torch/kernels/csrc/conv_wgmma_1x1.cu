// `conv1x1_wgmma`: the conv + batch-norm 1x1 GEMM on wgmma + TMA (kernels
// 11 and 13 of the experiment scripts: tools/exp_conv_bn.py `_kernel`,
// tools/exp_conv_bn2.py `_k_mm`, `_k_stat`, `_k_pro`).  The kernel is
// conv_wgmma.cuh's template; the design is in conv_bn.cu's header.  A
// source of its own, so nvcc builds it beside the others.
#include "conv_wgmma.cuh"

namespace paddle_conv {

int conv1x1_wgmma(const ConvCall& c) { return launch_conv<false>(c); }

}  // namespace paddle_conv
