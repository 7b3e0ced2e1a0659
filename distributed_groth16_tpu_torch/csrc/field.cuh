// Montgomery field arithmetic for the hand-written Hopper kernels.
//
// Device counterpart of ops/field.py's integer core and of LimbField /
// LimbFq2 in ops/limb_kernels.py. Elements are NW 32-bit words
// (little-endian), Montgomery form with R = 2^(32*NW), kept REDUNDANT in
// [0, 2p) exactly as the plain PyTorch versions keep them:
//
//   mul : (ab + Mp) / R with M = -ab/p mod R, no final subtraction. The
//         result is one integer whatever the word size, so 32-bit CIOS
//         here equals the 16-bit limb CIOS of the reference bit for bit.
//   add : cond_sub(a + b, 2p)
//   sub : cond_sub(a + (2p - b), 2p)
//
// The tensors crossing the kernel boundary hold 16-bit limbs in int32
// (the JAX package's layout); word w is limbs 2w | 2w+1 << 16.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dg16 {

template <int NW>
struct FieldConsts {
  uint32_t p[NW];
  uint32_t p2[NW];
  uint32_t n0;  // -p^{-1} mod 2^32
};

// r = t - m if t >= m else t
template <int NW>
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* t,
                                         const uint32_t* m) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - m[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = borrow ? t[j] : d[j];
}

template <int NW>
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  uint32_t t[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] + b[j] + carry;
    t[j] = (uint32_t)s;
    carry = s >> 32;
  }
  cond_sub<NW>(r, t, c.p2);
}

template <int NW>
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  uint32_t u[NW];  // 2p - b, b <= 2p
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)c.p2[j] - b[j] - borrow;
    u[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
  uint32_t t[NW];
  uint64_t carry = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a[j] + u[j] + carry;
    t[j] = (uint32_t)s;
    carry = s >> 32;
  }
  cond_sub<NW>(r, t, c.p2);
}

template <int NW>
struct Fe {
  uint32_t w[NW];
};

// CIOS Montgomery product, inputs < 2p, output < 2p. Not inlined: a G2
// add makes 42 of these, and inlining them all made one kernel too large
// for the compiler. Operands travel by value, so they stay in registers.
template <int NW>
__device__ __noinline__ Fe<NW> mont_mul(const Fe<NW> a, const Fe<NW> b,
                                        const FieldConsts<NW> c) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + carry;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * c.n0;
    s = (uint64_t)m * c.p[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * c.p[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[NW] + carry;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  Fe<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = t[j];
  return r;
}

// r = a * b (Montgomery); r may alias a or b.
template <int NW>
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  Fe<NW> x, y;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x.w[j] = a[j];
    y.w[j] = b[j];
  }
  Fe<NW> z = mont_mul<NW>(x, y, c);
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = z.w[j];
}

// Coordinate field of a group: the base field (DEG = 1) or Fq2 =
// Fq[u]/(u^2 + 1) (DEG = 2, words [c0 | c1]), with LimbFq2.make_ops'
// Karatsuba sequence.
template <int NW, int DEG>
struct Ext {
  static constexpr int W = NW * DEG;

  static __device__ __forceinline__ void add(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b,
                                             const FieldConsts<NW>& c) {
#pragma unroll
    for (int k = 0; k < DEG; ++k) fp_add<NW>(r + k * NW, a + k * NW, b + k * NW, c);
  }

  static __device__ __forceinline__ void sub(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b,
                                             const FieldConsts<NW>& c) {
#pragma unroll
    for (int k = 0; k < DEG; ++k) fp_sub<NW>(r + k * NW, a + k * NW, b + k * NW, c);
  }

  static __device__ __forceinline__ void mul(uint32_t* r, const uint32_t* a,
                                             const uint32_t* b,
                                             const FieldConsts<NW>& c) {
    if constexpr (DEG == 1) {
      fp_mul<NW>(r, a, b, c);
    } else {
      uint32_t t0[NW], t1[NW], sa[NW], sb[NW], s[NW];
      fp_mul<NW>(t0, a, b, c);
      fp_mul<NW>(t1, a + NW, b + NW, c);
      fp_add<NW>(sa, a, a + NW, c);
      fp_add<NW>(sb, b, b + NW, c);
      fp_mul<NW>(sa, sa, sb, c);
      fp_add<NW>(s, t0, t1, c);
      fp_sub<NW>(r, t0, t1, c);  // u^2 = -1
      fp_sub<NW>(r + NW, sa, s, c);
    }
  }
};

}  // namespace dg16
