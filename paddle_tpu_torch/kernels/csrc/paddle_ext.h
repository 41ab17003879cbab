// paddle_ext.h — the custom-operator ABI of paddle_tpu_torch's
// cpp_extension (utils/cpp_extension.py): from its pragma line on, the
// JAX package's header byte for byte, so one user source builds against
// either package.
//
// A custom op is an exported C function named  pt_op_<name>  with the
// signature below.  Tensors are host buffers: custom C++ runs on the host
// CPU; the op's wrapper copies card inputs to the host, calls it, and
// copies the outputs back to the inputs' device.
#pragma once
#include <cstdint>

extern "C" {

typedef struct {
  void* data;           // contiguous buffer
  const int64_t* shape; // dims
  int ndim;
  int dtype;            // 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool
} PT_Tensor;

// return 0 on success; nonzero aborts the op with an error
typedef int (*PT_OpFn)(const PT_Tensor* inputs, int n_inputs,
                       PT_Tensor* outputs, int n_outputs);

}  // extern "C"

// convenience: declare an op with the canonical exported name
#define PT_BUILD_OP(name)                                            \
  extern "C" int pt_op_##name(const PT_Tensor* inputs, int n_inputs, \
                              PT_Tensor* outputs, int n_outputs)
