// Group law (RCB16, a = 0) for the kernels of limb_group.cu, in two
// forms that follow LimbGroup.add_body and double_body of
// ops/limb_kernels.py operation for operation:
//
// - pt_add / pt_double: one projective point per thread, every value in
//   registers (kernels 1 and 2);
// - warp_add / warp_double: one point per warp, the independent products
//   of each formula step on different lanes (kernel 3, Horner).
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

// -- the group law spread over one warp ----------------------------------
//
// Values live in a shared-memory slot file: slot s holds one coordinate
// (NW * DEG words) at S + s * NW * DEG. A formula is a list of steps, each
// a set of independent operations, one per lane, ended by __syncwarp(); no
// step writes a slot that it reads. All lanes of a step run the same
// instructions on other slots, so the warp does a step's operations in the
// time of one.
// - product step: out = a * b. For DEG = 2 each product takes three lanes
//   (a0 b0, a1 b1, and (a0 + a1)(b0 + b1), whose lane forms the sums), then
//   a second step recombines, two lanes a product: c0 = t0 - (t1 + 0),
//   c1 = t2 - (t0 + t1), the same instructions on both lanes.
// - add step: out = a + b, DEG lanes an operation (one a component). A
//   step that mixes adds and subtracts (a - b) uses fp_addsub, which has
//   no branch, so its lanes do not diverge.
// Each operation equals the plain body's op for op, so the limbs do too.

// fixed slots: the accumulator X, Y, Z; the window column from kX2 (3, 4,
// 5); 3b
constexpr int kX = 0, kY = 1, kZ = 2, kX2 = 3, kB3 = 6;
constexpr int kSlots = 24;
constexpr int kMaxProducts = 6;  // per step

// one operation: a | b << 8 | out << 16 | sub << 24
constexpr uint32_t op(uint32_t a, uint32_t b, uint32_t out,
                      uint32_t sub = 0) {
  return a | b << 8 | out << 16 | sub << 24;
}

// The steps of warp_double (from 0) and warp_add (from 18), in order.
constexpr int kOpCount = 51;
__constant__ uint32_t kOps[kOpCount] = {
    // double: t0 t1 t2 txy (0) | t2b (4)
    op(1, 1, 7), op(1, 2, 8), op(2, 2, 9), op(0, 1, 10), op(9, kB3, 11),
    // 2 t0, y3a = t0 + t2b, 2 t2b (5) | 4 t0, 3 t2b (8) | z8, t0m (10)
    op(7, 7, 12), op(7, 11, 15), op(11, 11, 16), op(12, 12, 13),
    op(16, 11, 17), op(13, 13, 14), op(7, 17, 18, 1),
    // X3g Z3 Y3m X3m (12) | Y3 X3 (16)
    op(11, 14, 19), op(8, 14, kZ), op(18, 15, 20), op(18, 10, 21),
    op(19, 20, kY), op(21, 21, kX),
    // add: the six operand sums (18) | t0 t1 t2 and the sum products (24)
    op(0, 1, 7), op(3, 4, 8), op(1, 2, 9), op(4, 5, 10), op(0, 2, 11),
    op(3, 5, 12), op(0, 3, 13), op(1, 4, 14), op(2, 5, 15), op(7, 8, 16),
    op(9, 10, 17), op(11, 12, 18),
    // t0 + t1, t1 + t2, t0 + t2, 2 t0 (30) | t3 t4 ty, t03 = 2 t0 + t0 (34)
    op(13, 14, 19), op(14, 15, 20), op(13, 15, 21), op(13, 13, 22),
    op(16, 19, 7, 1), op(17, 20, 8, 1), op(18, 21, 9, 1), op(22, 13, 10),
    // t2b yb (38) | Z3' = t1 + t2b, t1m = t1 - t2b (40)
    op(15, kB3, 11), op(9, kB3, 12), op(14, 11, 16), op(14, 11, 17, 1),
    // the six products of r3 (42) | X3 = r0 - r1, Y3, Z3 (48)
    op(7, 17, 18), op(8, 12, 19), op(12, 10, 20), op(17, 16, 21),
    op(16, 8, 22), op(10, 7, 23), op(18, 19, kX, 1), op(20, 21, kY),
    op(22, 23, kZ),
};

// the table, copied to shared memory once: a step's lanes then read their
// operations in one load, not one constant-cache read per address
__device__ __forceinline__ void load_ops(uint32_t* T) {
  for (int i = threadIdx.x & 31; i < kOpCount; i += 32) T[i] = kOps[i];
}

// K adds (MIXED: adds and subtracts) from T[first .. first + K)
template <int NW, int DEG, bool MIXED>
__device__ __forceinline__ void warp_addsub(uint32_t* S, const uint32_t* T,
                                            int first, int K,
                                            const FieldConsts<NW>& c) {
  constexpr int E = NW * DEG;
  const int lane = threadIdx.x & 31;
  if (lane < DEG * K) {
    const uint32_t o = T[first + lane / DEG];
    const int part = (lane % DEG) * NW;
    uint32_t* r = S + ((o >> 16) & 0xff) * E + part;
    const uint32_t* a = S + (o & 0xff) * E + part;
    const uint32_t* b = S + ((o >> 8) & 0xff) * E + part;
    if constexpr (MIXED)
      fp_addsub<NW>(r, a, b, o >> 24, c);
    else
      fp_add<NW>(r, a, b, c);
  }
  __syncwarp();
}

// K coordinate products (T[first .. first + K)); X is the Fq2 scratch
// (3 * kMaxProducts * NW)
template <int NW, int DEG>
__device__ __forceinline__ void warp_mul(uint32_t* S, uint32_t* X,
                                         const uint32_t* T, int first, int K,
                                         const FieldConsts<NW>& c) {
  constexpr int E = NW * DEG;
  const int lane = threadIdx.x & 31;
  if constexpr (DEG == 1) {
    if (lane < K) {
      const uint32_t o = T[first + lane];
      fp_mul<NW>(S + ((o >> 16) & 0xff) * E, S + (o & 0xff) * E,
                 S + ((o >> 8) & 0xff) * E, c);
    }
    __syncwarp();
  } else {
    if (lane < 3 * K) {  // a0 b0, a1 b1, (a0 + a1)(b0 + b1)
      const int k = lane / 3, r = lane % 3;
      const uint32_t o = T[first + k];
      const uint32_t *a = S + (o & 0xff) * E, *b = S + ((o >> 8) & 0xff) * E;
      uint32_t x[NW], y[NW];
      if (r == 2) {
        fp_add<NW>(x, a, a + NW, c);
        fp_add<NW>(y, b, b + NW, c);
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          x[j] = a[r * NW + j];
          y[j] = b[r * NW + j];
        }
      }
      fp_mul<NW>(X + lane * NW, x, y, c);
    }
    __syncwarp();
    if (lane < 2 * K) {  // c0 = t0 - (t1 + 0), c1 = t2 - (t0 + t1)
      const int k = lane >> 1, odd = lane & 1;
      const uint32_t* t = X + 3 * k * NW;
      uint32_t u[NW], v[NW], s[NW], w[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        u[j] = t[(odd ? 0 : 1) * NW + j];
        v[j] = odd ? t[NW + j] : 0u;
        w[j] = t[(odd ? 2 : 0) * NW + j];
      }
      fp_add<NW>(s, u, v, c);  // t1 + 0 = t1: values are below 2p
      const uint32_t o = T[first + k];
      fp_sub<NW>(S + ((o >> 16) & 0xff) * E + odd * NW, w, s, c);
    }
    __syncwarp();
  }
}

// acc <- 2 acc: products 4 | 1 | 4 (double_body's r1, t2b, r3)
template <int NW, int DEG>
__device__ __forceinline__ void warp_double(uint32_t* S, uint32_t* X,
                                            const uint32_t* T,
                                            const FieldConsts<NW>& c) {
  warp_mul<NW, DEG>(S, X, T, 0, 4, c);
  warp_mul<NW, DEG>(S, X, T, 4, 1, c);
  warp_addsub<NW, DEG, false>(S, T, 5, 3, c);
  warp_addsub<NW, DEG, false>(S, T, 8, 2, c);
  warp_addsub<NW, DEG, true>(S, T, 10, 2, c);
  warp_mul<NW, DEG>(S, X, T, 12, 4, c);
  warp_addsub<NW, DEG, false>(S, T, 16, 2, c);
}

// acc <- acc + col: products 6 | 2 | 6 (add_body's r1, r2, r3)
template <int NW, int DEG>
__device__ __forceinline__ void warp_add(uint32_t* S, uint32_t* X,
                                         const uint32_t* T,
                                         const FieldConsts<NW>& c) {
  warp_addsub<NW, DEG, false>(S, T, 18, 6, c);
  warp_mul<NW, DEG>(S, X, T, 24, 6, c);
  warp_addsub<NW, DEG, false>(S, T, 30, 4, c);
  warp_addsub<NW, DEG, true>(S, T, 34, 4, c);
  warp_mul<NW, DEG>(S, X, T, 38, 2, c);
  warp_addsub<NW, DEG, true>(S, T, 40, 2, c);
  warp_mul<NW, DEG>(S, X, T, 42, 6, c);
  warp_addsub<NW, DEG, true>(S, T, 48, 3, c);
}

}  // namespace dg16
