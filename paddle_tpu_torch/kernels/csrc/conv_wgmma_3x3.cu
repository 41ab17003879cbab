// `conv3x3_wgmma`: the conv + batch-norm 3x3 implicit GEMM on wgmma + TMA
// (kernel 12 of the experiment scripts: tools/exp_conv3x3.py `_kernel`).
// The kernel is conv_wgmma.cuh's template; the design is in conv_bn.cu's
// header.  A source of its own, so nvcc builds it beside the others.
#include "conv_wgmma.cuh"

namespace paddle_conv {

int conv3x3_wgmma(const ConvCall& c) { return launch_conv<true>(c); }

}  // namespace paddle_conv
