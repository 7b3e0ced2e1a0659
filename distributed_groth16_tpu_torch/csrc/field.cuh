// Montgomery field arithmetic for the hand-written Hopper kernels.
//
// Device counterpart of ops/field.py's integer core and of LimbField /
// LimbFq2 in ops/limb_kernels.py. Elements are NW 32-bit words
// (little-endian), Montgomery form with R = 2^(32*NW), kept REDUNDANT in
// [0, 2p) exactly as the plain PyTorch versions keep them:
//
//   mul : (ab + Mp) / R with M = -ab/p mod R, no final subtraction. The
//         result is one integer whatever the word size or the order of
//         the partial products, so 32-bit CIOS here equals the 16-bit limb
//         CIOS of the reference bit for bit.
//   add : cond_sub(a + b, 2p)
//   sub : a - b, plus 2p on a borrow. For a, b in [0, 2p) that is the
//         integer cond_sub(a + (2p - b), 2p) of the plain version.
//
// Every multi-word sum is one carry chain in inline PTX (add.cc / addc,
// sub.cc / subc, mad.lo.cc / madc.hi.cc): the hardware carry flag links
// one word to the next, with no 64-bit sums to split. The chains need
// 4p < R (true for BN254 and BLS12): a CIOS row then fits NW + 1 words.
//
// The tensors crossing the kernel boundary hold 16-bit limbs in int32
// (the JAX package's layout); word w is limbs 2w | 2w+1 << 16.
//
// DG16_HOST_CHECK (never defined by the package's build) swaps the PTX for
// portable C++ with an emulated carry flag, so the same sources compile
// with a host compiler for a logic check (tools/kernel_host_check.py).
#pragma once

#include <cstdint>
#ifndef DG16_HOST_CHECK
#include <cuda_runtime.h>
#endif

namespace dg16 {

template <int NW>
struct FieldConsts {
  uint32_t p[NW];
  uint32_t p2[NW];
  uint32_t n0;  // -p^{-1} mod 2^32
};

// -- carry-chain primitives: one PTX instruction each --------------------
// The carry flag runs from one call to the next; `asm volatile` keeps the
// calls of a chain in program order.

#ifdef DG16_HOST_CHECK
inline thread_local uint32_t host_cf;  // emulated CC.CF

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b;
  host_cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)a + b + host_cf;
  host_cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  return a + b + host_cf;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  host_cf = a < b;
  return a - b;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint64_t s = (uint64_t)b + host_cf;
  uint32_t d = (uint32_t)((uint64_t)a - s);
  host_cf = (uint64_t)a < s;
  return d;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  return a - b - host_cf;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  return add_cc(a * b, c);
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  return addc_cc(a * b, c);
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  return add_cc((uint32_t)(((uint64_t)a * b) >> 32), c);
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  return addc_cc((uint32_t)(((uint64_t)a * b) >> 32), c);
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  return addc((uint32_t)(((uint64_t)a * b) >> 32), c);
}
#else
#define DG16_PTX2(name, ins)                                            \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {   \
    uint32_t d;                                                         \
    asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));       \
    return d;                                                           \
  }
#define DG16_PTX3(name, ins)                                            \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,     \
                                           uint32_t c) {                \
    uint32_t d;                                                         \
    asm volatile(ins " %0, %1, %2, %3;"                                 \
                 : "=r"(d) : "r"(a), "r"(b), "r"(c));                   \
    return d;                                                           \
  }
DG16_PTX2(add_cc, "add.cc.u32")
DG16_PTX2(addc_cc, "addc.cc.u32")
DG16_PTX2(addc, "addc.u32")
DG16_PTX2(sub_cc, "sub.cc.u32")
DG16_PTX2(subc_cc, "subc.cc.u32")
DG16_PTX2(subc, "subc.u32")
DG16_PTX3(mad_lo_cc, "mad.lo.cc.u32")
DG16_PTX3(madc_lo_cc, "madc.lo.cc.u32")
DG16_PTX3(mad_hi_cc, "mad.hi.cc.u32")
DG16_PTX3(madc_hi_cc, "madc.hi.cc.u32")
DG16_PTX3(madc_hi, "madc.hi.u32")
#undef DG16_PTX2
#undef DG16_PTX3
#endif

// r = t - m if t >= m else t (one subtract chain, a borrow mask, a select)
template <int NW>
__device__ __forceinline__ void cond_sub(uint32_t* r, const uint32_t* t,
                                         const uint32_t* m) {
  uint32_t d[NW];
  d[0] = sub_cc(t[0], m[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) d[j] = subc_cc(t[j], m[j]);
  const uint32_t borrow = subc(0, 0);  // all ones if t < m
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = (t[j] & borrow) | (d[j] & ~borrow);
}

// r = cond_sub(a + b, 2p); a + b < 4p < R, so the sum has no carry out
template <int NW>
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  uint32_t t[NW];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j] = addc_cc(a[j], b[j]);
  t[NW - 1] = addc(a[NW - 1], b[NW - 1]);
  cond_sub<NW>(r, t, c.p2);
}

// r = a - b, plus 2p if that borrowed
template <int NW>
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  uint32_t t[NW];
  t[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < NW; ++j) t[j] = subc_cc(a[j], b[j]);
  const uint32_t borrow = subc(0, 0);
  r[0] = add_cc(t[0], c.p2[0] & borrow);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) r[j] = addc_cc(t[j], c.p2[j] & borrow);
  r[NW - 1] = addc(t[NW - 1], c.p2[NW - 1] & borrow);
}

// fp_sub if sub else fp_add, with no branch: lanes of a warp that mix the
// two run one instruction stream. t = a + (b ^ f) + sub is a + b, or a - b
// with carry out co = (a >= b); d = t + (2p ^ ~f) + !sub is t - 2p (carry
// out c2 = t >= 2p) or t + 2p. Keep d if (sub ? !co : c2).
template <int NW>
__device__ __forceinline__ void fp_addsub(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b, uint32_t sub,
                                          const FieldConsts<NW>& c) {
  const uint32_t f = 0u - sub;
  uint32_t t[NW], d[NW];
  add_cc(sub, 0xffffffffu);  // carry in = sub
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = addc_cc(a[j], b[j] ^ f);
  const uint32_t co = addc(0, 0);
  add_cc(sub ^ 1u, 0xffffffffu);  // carry in = !sub
#pragma unroll
  for (int j = 0; j < NW; ++j) d[j] = addc_cc(t[j], c.p2[j] ^ ~f);
  const uint32_t c2 = addc(0, 0);
  const uint32_t keep = (f & (co - 1u)) | (~f & (0u - c2));
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = (d[j] & keep) | (t[j] & ~keep);
}

// CIOS Montgomery product, inputs < 2p, output < 2p; r may alias a or b.
// Each row is four carry chains: t += lo(a * b_i), t += hi(a * b_i) one
// word up, then the same for m * p with m = t_0 * n0, which zeroes t_0;
// dropping that word is the division by 2^32. t stays below 2^(32(NW+1)).
template <int NW>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b, const uint32_t* p,
                                         uint32_t n0) {
  uint32_t x[NW], y[NW], t[NW + 1];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    x[j] = a[j];
    y[j] = b[j];
    t[j] = 0;
  }
  t[NW] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    t[0] = mad_lo_cc(x[0], y[i], t[0]);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(x[j], y[i], t[j]);
    t[NW] = addc(t[NW], 0);
    t[1] = mad_hi_cc(x[0], y[i], t[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(x[j], y[i], t[j + 1]);
    t[NW] = madc_hi(x[NW - 1], y[i], t[NW]);

    const uint32_t m = t[0] * n0;
    t[0] = mad_lo_cc(m, p[0], t[0]);  // = 0, carry out
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(m, p[j], t[j]);
    t[NW] = addc(t[NW], 0);
    t[1] = mad_hi_cc(m, p[0], t[1]);
#pragma unroll
    for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(m, p[j], t[j + 1]);
    t[NW] = madc_hi(m, p[NW - 1], t[NW]);

#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
    t[NW] = 0;
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = t[j];
}

template <int NW>
struct Fe {
  uint32_t w[NW];
};

// The same product out of line, for kernels with many call sites (a G2
// add makes 42 products: inlined, each costs code and registers).
// Operands travel by value, so they stay in registers.
template <int NW>
__device__ __noinline__ Fe<NW> mont_mul_call(const Fe<NW> a, const Fe<NW> b,
                                             const Fe<NW> p, uint32_t n0) {
  Fe<NW> r;
  mont_mul<NW>(r.w, a.w, b.w, p.w, n0);
  return r;
}

// r = a * b (Montgomery); r may alias a or b. INL: inline the product.
template <int NW, bool INL = true>
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const FieldConsts<NW>& c) {
  if constexpr (INL) {
    mont_mul<NW>(r, a, b, c.p, c.n0);
  } else {
    Fe<NW> x, y, p;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      x.w[j] = a[j];
      y.w[j] = b[j];
      p.w[j] = c.p[j];
    }
    Fe<NW> z = mont_mul_call<NW>(x, y, p, c.n0);
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = z.w[j];
  }
}

// Coordinate field of a group: the base field (DEG = 1) or Fq2 =
// Fq[u]/(u^2 + 1) (DEG = 2, words [c0 | c1]), with LimbFq2.make_ops'
// Karatsuba sequence, its Fp products out of line (kernels 1 and 2 make
// 14-42 of them per point; Horner calls fp_mul itself, inlined).
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
      fp_mul<NW, false>(r, a, b, c);
    } else {
      uint32_t t0[NW], t1[NW], sa[NW], sb[NW], s[NW];
      fp_mul<NW, false>(t0, a, b, c);
      fp_mul<NW, false>(t1, a + NW, b + NW, c);
      fp_add<NW>(sa, a, a + NW, c);
      fp_add<NW>(sb, b, b + NW, c);
      fp_mul<NW, false>(sa, sa, sb, c);
      fp_add<NW>(s, t0, t1, c);
      fp_sub<NW>(r, t0, t1, c);  // u^2 = -1
      fp_sub<NW>(r + NW, sa, s, c);
    }
  }
};

}  // namespace dg16
