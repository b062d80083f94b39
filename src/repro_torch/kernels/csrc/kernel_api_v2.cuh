// Device and launch helpers of the redesigned per-client kernels
// (pack_bits.cu, dequant.cu, quantize.cu, roundtrip.cu, unpack_bits.cu,
// unpack_dequant.cu): streamed loads, programmatic dependent launch (PDL,
// Hopper), and the bit-plane unpack of one value.
//
// PDL: a kernel launched with launch_pdl() may be scheduled
// while the kernel before it on the stream is still running, once every
// block of that kernel has executed launch_dependents() or exited.  Its
// blocks then set up (parameters, index arithmetic) beside the earlier
// kernel's tail, and grid_dependency_wait() holds each thread until the
// earlier kernel has completed and its writes are visible.  So every
// kernel launched this way calls grid_dependency_wait() before its first
// global load or store: the inputs the kernel before wrote (read after
// write) and the buffers it still reads (write after read) are then safe.
// A kernel launched without the attribute, or after a kernel that is not
// a kernel (a copy, a fill, an event), waits for nothing here.
//
// Every load below is `asm volatile` with a memory clobber, so the
// compiler keeps it after the wait, which is one too, and none is a
// non-coherent (.nc) load: ptxas takes such a load's data as fixed for
// the kernel's lifetime and may hoist it above the wait (an
// LDG...CONSTANT came out before the ACQBULK of griddepcontrol.wait).
// chip_smoke.py checks the SASS of every kernel that waits.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

// griddepcontrol.wait: returns once the grids this one depends on have
// completed and their memory operations are visible to it.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// griddepcontrol.launch_dependents: the next kernel on the stream may be
// scheduled once every block has executed this or exited.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Read-once loads: not kept in L1, and a miss fetches the 256 B around
// it into L2, so a warp's loads of a row share DRAM bursts.  Coherent
// loads, so they stay after grid_dependency_wait().
__device__ __forceinline__ uint32_t load_streamed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.L1::no_allocate.L2::256B.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 load_streamed_v4(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p)
      : "memory");
  return v;
}

__device__ __forceinline__ uint2 load_streamed_v2(const void* p) {
  uint2 v;
  asm volatile("ld.global.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

// The f32 views of the loads above.
__device__ __forceinline__ float load_streamed_f32(const float* p) {
  return __uint_as_float(load_streamed((const uint32_t*)p));
}

// Four consecutive floats from p, by loads of VEC floats each (VEC 4: one
// 16-byte load, 2: two 8-byte loads; p aligned to 4 * VEC bytes), both
// issued before either is used.
template <int VEC>
__device__ __forceinline__ void load_streamed_f32x4(const float* p,
                                                    float (&v)[4]) {
  static_assert(VEC == 2 || VEC == 4, "VEC is 2 or 4");
  if constexpr (VEC == 4) {
    const uint4 w = load_streamed_v4(p);
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  } else {
    const uint2 a = load_streamed_v2(p), b = load_streamed_v2(p + 2);
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(b.x);
    v[3] = __uint_as_float(b.y);
  }
}

// The wider of 4 and 2 floats whose loads an address is aligned for, or 0
// when it is only 4-byte aligned; pass the or of several addresses for
// the width that all of them take.
static inline int f32_vector_width(uintptr_t addrs) {
  return (addrs & 15) == 0 ? 4 : (addrs & 7) == 0 ? 2 : 0;
}

// One signed byte, sign-extended.
__device__ __forceinline__ int load_streamed_s8(const int8_t* p) {
  int v;
  asm volatile("ld.global.L1::no_allocate.L2::256B.s8 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Launch `kernel` on a 1-D grid with programmatic stream serialization;
// -> the launch's error (0 when it was queued).
template <typename... Params, typename... Args>
static int launch_pdl(void (*kernel)(Params...), unsigned blocks,
                      unsigned threads, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();   // clear it either way
  return (int)(err != cudaSuccess ? err : last);
}

// ---------------------------------------------------------------------
// The bit-plane unpack of one value (unpack_bits.cu, and unpack_dequant.cu's
// scalar threads): its group's plane words, then its lane's bits.

// A group's BITS plane words from p, every load issued before any is used.
template <int BITS>
__device__ __forceinline__ void load_planes(const uint32_t* p,
                                            uint32_t (&x)[BITS]) {
#pragma unroll
  for (int b = 0; b < BITS; ++b) x[b] = load_streamed(p + b);
}

// The value of lane `lane` of a group from its plane words.
template <int BITS>
__device__ __forceinline__ uint32_t lane_value(const uint32_t (&x)[BITS],
                                               int lane) {
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < BITS; ++b) v |= ((x[b] >> lane) & 1u) << b;
  return v;
}
