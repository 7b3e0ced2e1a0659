// Group law (RCB16, a = 0) for the kernels of limb_group.cu, in three
// forms that follow LimbGroup.add_body and double_body of
// ops/limb_kernels.py operation for operation:
//
// - pt_add: one projective point per thread, its operands in registers
//   or staged in shared memory (kernel 1);
// - warps_double: one point per lane of three warps, each warp three of
//   the products, values handed on through shared memory (kernel 2);
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

// -- the doubling spread over three warps (kernel 2) ---------------------
//
// A block of three warps doubles 32 points: lane l of every warp works on
// point l, and warp w runs role w, three of double_body's nine products
// each:
//
//   warp 0          | warp 1          | warp 2
//   t2  = Z Z       | t0  = Y Y       | t1  = Y Z
//   t2b = t2 3b     | txy = X Y       | Z3  = t1 z8
//   X3g = t2b z8    | X3m = t0m txy   | Y3m = t0m y3a
//
// Values cross warps through a slot file in shared memory, each handed on
// by a named barrier that its producer arrives at and its consumers wait
// on: warp 1 hands on t0 and z8 = 8 t0 (kHandZ8), warp 0 y3a and
// t0m = t0 - 3 t2b (kHandT0m), warp 2 Y3m (kHandY3m). A point waits the
// chain t2 -> t2b -> t0m -> Y3m, 3 product latencies and not 9; a warp
// runs one role for 32 points, so no lane idles or diverges, and each add
// runs once, on the warp that needs it. Each value is the plain body's,
// from the same operands, so the limbs are too. Every warp reaches its
// barriers whatever its lanes hold; only live lanes load and store.

// word k of slot s of the block's lane l at S[(s * W + k) * 32 + l]:
// a warp reads and writes 32 neighbouring words
constexpr int kSlotT0 = 0, kSlotZ8 = 1, kSlotY3a = 2, kSlotT0m = 3;
constexpr int kSlotY3m = kSlotT0;  // t0 is dead once kHandT0m has passed
constexpr int kDoubleSlots = 4;
// named barriers (0 is __syncthreads) and how many threads meet at each
constexpr int kHandZ8 = 1, kHandT0m = 2, kHandY3m = 3;

#ifdef DG16_HOST_CHECK
void bar_arrive(int id, int threads);  // tools/host_check.cpp
void bar_wait(int id, int threads);
#else
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_wait(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
#endif

template <int W>
__device__ __forceinline__ void put_slot(uint32_t* S, int slot, int lane,
                                         const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < W; ++k) S[(slot * W + k) * 32 + lane] = v[k];
}

template <int W>
__device__ __forceinline__ void get_slot(uint32_t* v, const uint32_t* S,
                                         int slot, int lane) {
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = S[(slot * W + k) * 32 + lane];
}

// coordinate `which` (0 X, 1 Y, 2 Z; W words) of the point in column col
template <int W>
__device__ __forceinline__ void load_coord(uint32_t* v, const int32_t* src,
                                           long long rs, long long col,
                                           int which, bool live) {
  if (live) {
    const int32_t* e = src + (long long)(2 * W * which) * rs + col;
#pragma unroll
    for (int i = 0; i < W; ++i)
      v[i] = (uint32_t)e[(2 * i) * rs] | ((uint32_t)e[(2 * i + 1) * rs] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = 0;
  }
}

template <int W>
__device__ __forceinline__ void store_coord(int32_t* dst, long long rs,
                                            long long col, int which,
                                            const uint32_t* v) {
  int32_t* e = dst + (long long)(2 * W * which) * rs + col;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    e[(2 * i) * rs] = (int32_t)(v[i] & 0xffffu);
    e[(2 * i + 1) * rs] = (int32_t)(v[i] >> 16);
  }
}

// -- kernel 1: the add of one point per thread ---------------------------
//
// The formula is written once, over an operand source that yields a
// coordinate (0 X, 1 Y, 2 Z; W words) at each use: RegPoint reads the
// thread's registers, SharedPoint the thread's slot file in shared memory
// (word k of coordinate `which` at [(which * W + k) * stride]) with a
// volatile read, so the compiler keeps no copy of it in registers between
// uses. Held in registers, two G2 operands at 12 words are 144 words
// before any temporary and spill; staged, they do not (limb_group.cu
// kStagedAdd). Each output coordinate is stored as soon as it is final.

template <int W>
struct RegPoint {
  const uint32_t* v;
  __device__ __forceinline__ void get(uint32_t* dst, int which) const {
#pragma unroll
    for (int k = 0; k < W; ++k) dst[k] = v[which * W + k];
  }
};

template <int W>
struct SharedPoint {
  const volatile uint32_t* S;
  int stride;
  __device__ __forceinline__ void get(uint32_t* dst, int which) const {
#pragma unroll
    for (int k = 0; k < W; ++k) dst[k] = S[(which * W + k) * stride];
  }
};

template <int NW, int DEG, class Src>
__device__ __forceinline__ void pt_add(const Src& P, const Src& Q,
                                       int32_t* out, long long n, long long j,
                                       const GroupConsts<NW, DEG>& g) {
  using E = Ext<NW, DEG>;
  constexpr int W = E::W;
  const auto& c = g.f;
  uint32_t t0[W], t1[W], t2[W], t3[W], t4[W], ty[W], a[W], b[W];
  P.get(a, 0);
  Q.get(b, 0);
  E::mul(t0, a, b, c);  // X1 X2
  P.get(a, 1);
  Q.get(b, 1);
  E::mul(t1, a, b, c);  // Y1 Y2
  P.get(a, 2);
  Q.get(b, 2);
  E::mul(t2, a, b, c);  // Z1 Z2
  // t3 = (X1 + Y1)(X2 + Y2) - (t0 + t1); the product's output is scratch
  P.get(a, 0);
  P.get(t3, 1);
  E::add(a, a, t3, c);
  Q.get(b, 0);
  Q.get(t3, 1);
  E::add(b, b, t3, c);
  E::mul(t3, a, b, c);
  E::add(a, t0, t1, c);
  E::sub(t3, t3, a, c);
  // t4 = (Y1 + Z1)(Y2 + Z2) - (t1 + t2)
  P.get(a, 1);
  P.get(t4, 2);
  E::add(a, a, t4, c);
  Q.get(b, 1);
  Q.get(t4, 2);
  E::add(b, b, t4, c);
  E::mul(t4, a, b, c);
  E::add(a, t1, t2, c);
  E::sub(t4, t4, a, c);
  // ty = (X1 + Z1)(X2 + Z2) - (t0 + t2)
  P.get(a, 0);
  P.get(ty, 2);
  E::add(a, a, ty, c);
  Q.get(b, 0);
  Q.get(ty, 2);
  E::add(b, b, ty, c);
  E::mul(ty, a, b, c);
  E::add(a, t0, t2, c);
  E::sub(ty, ty, a, c);
  E::add(a, t0, t0, c);
  E::add(t0, a, t0, c);     // t03 = 3 t0
  E::mul(t2, t2, g.b3, c);  // t2b
  E::mul(ty, ty, g.b3, c);  // yb
  E::add(a, t1, t2, c);     // Z3' = t1 + t2b
  E::sub(t1, t1, t2, c);    // t1m = t1 - t2b
  E::mul(t2, t3, t1, c);
  E::mul(b, t4, ty, c);
  E::sub(b, t2, b, c);  // X3 = t3 t1m - t4 yb
  store_coord<W>(out, n, j, 0, b);
  E::mul(t2, ty, t0, c);
  E::mul(b, t1, a, c);
  E::add(b, t2, b, c);  // Y3 = yb t03 + t1m Z3'
  store_coord<W>(out, n, j, 1, b);
  E::mul(t2, a, t4, c);
  E::mul(b, t0, t3, c);
  E::add(b, t2, b, c);  // Z3 = Z3' t4 + t03 t3
  store_coord<W>(out, n, j, 2, b);
}

// Role `role` (the warp) of the block's doubling for the point in column j
// (input column col = j * column stride) on `lane`; out is contiguous
// (ROWS, n); S holds kDoubleSlots * W * 32 words.
template <int NW, int DEG>
__device__ __forceinline__ void warps_double(const int32_t* p, long long p_rs,
                                             long long col, int32_t* out,
                                             long long n, long long j,
                                             bool live, int role, int lane,
                                             uint32_t* S,
                                             const GroupConsts<NW, DEG>& g) {
  using E = Ext<NW, DEG>;
  constexpr int W = E::W;
  const auto& c = g.f;
  uint32_t a[W], b[W], d[W];
  if (role == 0) {
    load_coord<W>(a, p, p_rs, col, 2, live);
    E::mul(a, a, a, c);     // t2 = Z Z
    E::mul(a, a, g.b3, c);  // t2b
    bar_wait(kHandZ8, 96);
    get_slot<W>(b, S, kSlotT0, lane);
    E::add(d, b, a, c);
    put_slot<W>(S, kSlotY3a, lane, d);  // y3a = t0 + t2b
    E::add(d, a, a, c);
    E::add(d, d, a, c);
    E::sub(d, b, d, c);
    put_slot<W>(S, kSlotT0m, lane, d);  // t0m = t0 - 3 t2b
    bar_arrive(kHandT0m, 96);
    get_slot<W>(b, S, kSlotZ8, lane);
    E::mul(a, a, b, c);  // X3g = t2b z8
    bar_wait(kHandY3m, 64);
    get_slot<W>(b, S, kSlotY3m, lane);
    E::add(a, a, b, c);  // Y3 = X3g + Y3m
    if (live) store_coord<W>(out, n, j, 1, a);
  } else if (role == 1) {
    load_coord<W>(a, p, p_rs, col, 1, live);
    load_coord<W>(b, p, p_rs, col, 0, live);
    E::mul(d, a, a, c);  // t0 = Y Y
    put_slot<W>(S, kSlotT0, lane, d);
    E::add(d, d, d, c);
    E::add(d, d, d, c);
    E::add(d, d, d, c);
    put_slot<W>(S, kSlotZ8, lane, d);  // z8 = 8 Y^2
    bar_arrive(kHandZ8, 96);
    E::mul(a, b, a, c);  // txy = X Y
    bar_wait(kHandT0m, 96);
    get_slot<W>(b, S, kSlotT0m, lane);
    E::mul(a, b, a, c);  // X3m = t0m txy
    E::add(a, a, a, c);  // X3 = X3m + X3m
    if (live) store_coord<W>(out, n, j, 0, a);
  } else {
    load_coord<W>(a, p, p_rs, col, 1, live);
    load_coord<W>(b, p, p_rs, col, 2, live);
    E::mul(a, a, b, c);  // t1 = Y Z
    bar_wait(kHandZ8, 96);
    get_slot<W>(b, S, kSlotZ8, lane);
    E::mul(a, a, b, c);  // Z3 = t1 z8
    if (live) store_coord<W>(out, n, j, 2, a);
    bar_wait(kHandT0m, 96);
    get_slot<W>(a, S, kSlotT0m, lane);
    get_slot<W>(b, S, kSlotY3a, lane);
    E::mul(a, a, b, c);  // Y3m = t0m y3a
    put_slot<W>(S, kSlotY3m, lane, a);
    bar_arrive(kHandY3m, 64);
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
