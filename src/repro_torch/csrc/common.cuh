// Shared helpers of the port's hand-written Hopper kernels: element
// conversion to and from float, aligned vector loads, and the dtype codes
// the Python wrappers pass through the plain C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;   // the reference's masked score
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_FP8 = 2;        // e4m3 K/V storage, decode pair only

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ __forceinline__ static float to_f(float x) { return x; }
  __device__ __forceinline__ static float from_f(float x) { return x; }
  // two neighbouring elements (the f32 smem rows are padded to an odd
  // stride, so no 8-byte alignment: two scalar loads)
  __device__ __forceinline__ static float2 ld2(const float* p) {
    return make_float2(p[0], p[1]);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
  __device__ __forceinline__ static float2 ld2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// N consecutive elements in one aligned vector load (16 bytes for 4 f32,
// 8 for 4 bf16), widened to float.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = Cvt<T>::to_f(x.v[e]);
}

}  // namespace rt
