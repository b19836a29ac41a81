// Double-single (hi + lo float32 pair) arithmetic for the DS kernels.
//
// The device counterpart of spmv_torch/ds.py (and of spmv_tpu/ds.py): the
// same operation sequence, so a kernel's hi and lo planes equal the plain
// torch version's bit for bit.
//
// nvcc contracts a*b + c into one fma by default (-fmad=true, kept for the
// other kernels). A contracted step rounds once where the error-free
// transformation needs two roundings, and two_sum / ds_mul_f32 then lose
// their error terms without any visible failure on smooth data. So every
// add, subtract and multiply below is an __fadd_rn / __fsub_rn / __fmul_rn
// intrinsic, which nvcc never contracts or reorders. The one fma is
// two_prod's error term, fmaf(a, b, -p): exact, and equal to Dekker's
// split-based term whenever a*b neither overflows nor underflows.

#pragma once

#include <cuda_runtime.h>

struct Ds {
  float hi, lo;
};

// Knuth's error-free sum: a + b = s + e exactly.
__device__ __forceinline__ Ds ds_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return {s, e};
}

// Dekker's error-free sum for |a| >= |b|.
__device__ __forceinline__ Ds ds_fast_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// (ah + al) + (bh + bl), normalized (spmv_torch.ds.ds_add).
__device__ __forceinline__ Ds ds_add(Ds a, Ds b) {
  const Ds s = ds_two_sum(a.hi, b.hi);
  return ds_fast_two_sum(s.hi, __fadd_rn(s.lo, __fadd_rn(a.lo, b.lo)));
}

// (ah + al) * (bh + bl) without the al*bl term, normalized
// (spmv_torch.ds.ds_mul_f32).
__device__ __forceinline__ Ds ds_mul_f32(Ds a, Ds b) {
  const float p = __fmul_rn(a.hi, b.hi);
  const float e = fmaf(a.hi, b.hi, -p);  // exact: a.hi*b.hi - p
  const float cross = __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi));
  return ds_fast_two_sum(p, __fadd_rn(e, cross));
}
