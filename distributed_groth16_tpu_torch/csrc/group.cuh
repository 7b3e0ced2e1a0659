// Group law on one projective point per thread (RCB16, a = 0) for the
// kernels of limb_group.cu: pt_add and pt_double follow LimbGroup.add_body
// and double_body of ops/limb_kernels.py operation for operation.
#pragma once

#include "field.cuh"

namespace dg16 {

template <int NW, int DEG>
struct GroupConsts {
  FieldConsts<NW> f;
  uint32_t b3[NW * DEG];  // 3b, Montgomery
};

template <int NW, int DEG>
__device__ __forceinline__ void pt_add(uint32_t* out, const uint32_t* P,
                                       const uint32_t* Q,
                                       const GroupConsts<NW, DEG>& g) {
  using E = Ext<NW, DEG>;
  constexpr int W = E::W;
  const auto& c = g.f;
  const uint32_t *X1 = P, *Y1 = P + W, *Z1 = P + 2 * W;
  const uint32_t *X2 = Q, *Y2 = Q + W, *Z2 = Q + 2 * W;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], ty[W], a[W], b[W];
  E::mul(t0, X1, X2, c);
  E::mul(t1, Y1, Y2, c);
  E::mul(t2, Z1, Z2, c);
  E::add(a, X1, Y1, c);
  E::add(b, X2, Y2, c);
  E::mul(t3, a, b, c);
  E::add(a, t0, t1, c);
  E::sub(t3, t3, a, c);
  E::add(a, Y1, Z1, c);
  E::add(b, Y2, Z2, c);
  E::mul(t4, a, b, c);
  E::add(a, t1, t2, c);
  E::sub(t4, t4, a, c);
  E::add(a, X1, Z1, c);
  E::add(b, X2, Z2, c);
  E::mul(ty, a, b, c);
  E::add(a, t0, t2, c);
  E::sub(ty, ty, a, c);
  uint32_t t03[W];  // 3 * t0
  E::add(t03, t0, t0, c);
  E::add(t03, t03, t0, c);
  uint32_t t2b[W], yb[W];
  E::mul(t2b, t2, g.b3, c);
  E::mul(yb, ty, g.b3, c);
  uint32_t z3[W], t1m[W];
  E::add(z3, t1, t2b, c);
  E::sub(t1m, t1, t2b, c);
  // all inputs are dead from here on, so out may alias P or Q
  E::mul(a, t3, t1m, c);
  E::mul(b, t4, yb, c);
  E::sub(out, a, b, c);
  E::mul(a, yb, t03, c);
  E::mul(b, t1m, z3, c);
  E::add(out + W, a, b, c);
  E::mul(a, z3, t4, c);
  E::mul(b, t03, t3, c);
  E::add(out + 2 * W, a, b, c);
}

template <int NW, int DEG>
__device__ __forceinline__ void pt_double(uint32_t* out, const uint32_t* P,
                                          const GroupConsts<NW, DEG>& g) {
  using E = Ext<NW, DEG>;
  constexpr int W = E::W;
  const auto& c = g.f;
  const uint32_t *X = P, *Y = P + W, *Z = P + 2 * W;
  uint32_t t0[W], t1[W], t2[W], txy[W], z8[W], t2b[W], y3a[W], s[W];
  E::mul(t0, Y, Y, c);
  E::mul(t1, Y, Z, c);
  E::mul(t2, Z, Z, c);
  E::mul(txy, X, Y, c);
  E::add(z8, t0, t0, c);
  E::add(z8, z8, z8, c);
  E::add(z8, z8, z8, c);  // 8 Y^2
  E::mul(t2b, t2, g.b3, c);
  E::add(y3a, t0, t2b, c);
  E::add(s, t2b, t2b, c);
  E::add(s, s, t2b, c);
  E::sub(t0, t0, s, c);  // t0m = Y^2 - 3 * b3 Z^2
  // P is dead from here on
  E::mul(s, t2b, z8, c);         // X3g
  E::mul(out + 2 * W, t1, z8, c);  // Z3
  E::mul(t2, t0, y3a, c);        // Y3m
  E::mul(t1, t0, txy, c);        // X3m
  E::add(out + W, s, t2, c);
  E::add(out, t1, t1, c);
}

template <int NW, int DEG>
__device__ __forceinline__ void load_point(uint32_t* P, const int32_t* src,
                                           long long rs, long long col) {
  constexpr int WORDS = 3 * NW * DEG;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    uint32_t lo = (uint32_t)src[(2 * i) * rs + col];
    uint32_t hi = (uint32_t)src[(2 * i + 1) * rs + col];
    P[i] = lo | (hi << 16);
  }
}

template <int NW, int DEG>
__device__ __forceinline__ void store_point(int32_t* dst, long long rs,
                                            long long col, const uint32_t* P) {
  constexpr int WORDS = 3 * NW * DEG;
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    dst[(2 * i) * rs + col] = (int32_t)(P[i] & 0xffffu);
    dst[(2 * i + 1) * rs + col] = (int32_t)(P[i] >> 16);
  }
}

}  // namespace dg16
