// Decode attention's device markers.
//
// Two empty one-thread kernels that ops/attention.py:decode_attention
// launches first and last on the current stream, so that a profiler's
// record of the device (torch.profiler, Nsight Systems) shows the layer's
// device time as the kernels between a begin and the next end, inside CUDA
// graph replays too.  They are extern "C", so the profiler shows their names
// verbatim: nf4_mark_decode_attn_begin and nf4_mark_decode_attn_end.
//
// Not a kernel of the TPU package and not counted in ops/_cuda.py's
// launch counts: utils/trace.py launches them through nf4_mark.

#include <cuda_runtime.h>

extern "C" __global__ void nf4_mark_decode_attn_begin() {}

extern "C" __global__ void nf4_mark_decode_attn_end() {}

// which: 0 launches the begin marker, 1 the end marker.
extern "C" int nf4_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) nf4_mark_decode_attn_begin<<<1, 1, 0, s>>>();
  else if (which == 1) nf4_mark_decode_attn_end<<<1, 1, 0, s>>>();
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
