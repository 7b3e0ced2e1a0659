// Kernels 1-3: complete projective add, doubling and the MSM window
// combine (Horner) for short-Weierstrass groups with a = 0 (BN254 G1 over
// Fq, G2 over Fq2), on limb-major point batches.
//
// Replace the Pallas TPU kernels of distributed_groth16_tpu/ops/
// limb_kernels.py: LimbGroup._pallas_add (body add_body), _pallas_double
// (double_body) and _horner (horner_body). The formulas, and the order of
// every field operation in them, follow those bodies (RCB16 algorithms 7
// and 9), so results equal the plain PyTorch versions limb for limb.
//
// Layout: a batch is int32[ROWS, n] of 16-bit limbs, ROWS = 3 * CR with
// CR = 16 (G1) or 32 (G2); rows X, Y, Z, each CR rows.
//
// Kernel 1: one thread owns one point column; neighbouring threads read
// neighbouring addresses in every limb row, so each row load and store is
// coalesced. Inputs may be strided views (row stride, column stride), the
// ragged last block is masked, nothing is padded. What bounds it: integer
// multiply-adds (a G1 add is 14 Montgomery products against 288 bytes
// moved per point; G2 triples the products), so every value stays in
// registers. Both groups call one out-of-line product: inlined, the 14 or
// 42 product sites outgrow the instruction cache and run slower
// (PERF.md). The launch bounds ask only for blocks of 128 threads: G1
// then takes 118 registers, G2 235, with no spill; forcing more blocks
// per SM spills and runs slower.
//
// Kernel 2 (the doubling of ladder_apply, on the MPC path only) runs at
// 8-16 columns in every round's unpack and at 27,626-65,536 in the CRS
// pack. At the narrow widths one point's chain of dependent products is
// the whole launch; at the pack's widths one point per thread is a single
// wave of blocks, bound by issue slots, whose load, product and store
// phases do not overlap. So a point takes a lane in each of a block's
// three warps (group.cuh warps_double): the chain falls from 9 product
// latencies to 3, each warp issues only its own third of the products and
// adds (a point per few lanes of one warp would idle lanes and repeat the
// adds on each), and three times the threads fill the card in several
// waves, so one wave's loads and stores overlap another's products. Same
// strides, masking and out-of-line product as kernel 1.
//
// Kernel 3 (Horner) is a W-1 step dependency chain on a single point:
// latency, not throughput, bounds it. One warp owns the point. The W
// window sums are staged in shared memory once; each doubling and each add
// runs as the warp-spread steps of group.cuh, the independent products of
// a step on different lanes (4 | 1 | 4 per doubling, 6 | 2 | 6 per add;
// G2 puts each Fq2 product's three Fp products on lanes of their own), so
// the chain is 3 product latencies per group operation instead of 9 / 14.
#include "group.cuh"

namespace dg16 {

constexpr int kThreads = 128;
constexpr int kHornerMaxW = 64;  // window columns staged (c = 4: W = 64)

template <int NW, int DEG>
__global__ void __launch_bounds__(kThreads)
    add_kernel(const int32_t* p, long long p_rs, long long p_cs,
               const int32_t* q, long long q_rs, long long q_cs, int32_t* out,
               long long n, const GroupConsts<NW, DEG> g) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t P[3 * NW * DEG], Q[3 * NW * DEG];
  load_point<NW, DEG>(P, p, p_rs, j * p_cs);
  load_point<NW, DEG>(Q, q, q_rs, j * q_cs);
  pt_add<NW, DEG>(P, P, Q, g);
  store_point<NW, DEG>(out, n, j, P);
}

// a point per lane of three warps: 32 points a block
constexpr int kDoubleThreads = 3 * 32;

template <int NW, int DEG>
__global__ void __launch_bounds__(kDoubleThreads)
    double_kernel(const int32_t* p, long long p_rs, long long p_cs,
                  int32_t* out, long long n, const GroupConsts<NW, DEG> g) {
  __shared__ uint32_t S[kDoubleSlots * NW * DEG * 32];
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * 32 + lane;
  warps_double<NW, DEG>(p, p_rs, j * p_cs, out, n, j, j < n,
                        threadIdx.x / 32, lane, S, g);
}

// acc = sum_w 2^(c*w) * S_w over the W columns of s (LSB window first),
// s int32[ROWS, W] contiguous, 2 <= W <= kHornerMaxW. One block, one warp.
template <int NW, int DEG>
__global__ void __launch_bounds__(32)
    horner_kernel(const int32_t* s, int W, int c, int32_t* out,
                  const GroupConsts<NW, DEG> g) {
  constexpr int E = NW * DEG, WORDS = 3 * E;
  __shared__ uint32_t win[kHornerMaxW * WORDS];  // column w at w * WORDS
  __shared__ uint32_t S[kSlots * E];
  __shared__ uint32_t X[3 * kMaxProducts * NW];
  __shared__ uint32_t T[kOpCount];
  const int lane = threadIdx.x;
  load_ops(T);
  for (int idx = lane; idx < W * WORDS; idx += 32) {
    const int w = idx % W, i = idx / W;  // neighbouring lanes: neighbouring w
    win[w * WORDS + i] = (uint32_t)s[(2 * i) * W + w] |
                         ((uint32_t)s[(2 * i + 1) * W + w] << 16);
  }
  __syncwarp();
  for (int i = lane; i < WORDS; i += 32) S[i] = win[(W - 1) * WORDS + i];
  for (int i = lane; i < E; i += 32) S[kB3 * E + i] = g.b3[i];
  __syncwarp();
  for (int w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k)
      warp_double<NW, DEG>(S, X, T, g.f);
    for (int i = lane; i < WORDS; i += 32) S[kX2 * E + i] = win[w * WORDS + i];
    __syncwarp();
    warp_add<NW, DEG>(S, X, T, g.f);
  }
  for (int i = lane; i < WORDS; i += 32) {
    out[2 * i] = (int32_t)(S[i] & 0xffffu);
    out[2 * i + 1] = (int32_t)(S[i] >> 16);
  }
}

// Latency probe for Horner's chain bound (chip_smoke.py; not a port of a
// TPU kernel): one warp, each lane squaring its own element of x n times,
// each product waiting on the last, with the inlined product Horner uses
// (per-lane values keep it on the vector pipeline, as in Horner).
template <int NW>
__global__ void mont_chain_kernel(uint32_t* x, long long n,
                                  const FieldConsts<NW> c) {
  uint32_t v[NW];
  uint32_t* e = x + threadIdx.x * NW;
#pragma unroll
  for (int j = 0; j < NW; ++j) v[j] = e[j];
  for (long long i = 0; i < n; ++i) fp_mul<NW>(v, v, v, c);
#pragma unroll
  for (int j = 0; j < NW; ++j) e[j] = v[j];
}

// consts: words p[NW], 2p[NW], 3b[NW * DEG], n0
template <int NW, int DEG>
GroupConsts<NW, DEG> unpack(const uint32_t* w) {
  GroupConsts<NW, DEG> g;
  for (int i = 0; i < NW; ++i) g.f.p[i] = w[i];
  for (int i = 0; i < NW; ++i) g.f.p2[i] = w[NW + i];
  for (int i = 0; i < NW * DEG; ++i) g.b3[i] = w[2 * NW + i];
  g.f.n0 = w[2 * NW + NW * DEG];
  return g;
}

#ifndef DG16_HOST_CHECK
inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <int NW, int DEG>
int launch_add(const int32_t* p, long long p_rs, long long p_cs,
               const int32_t* q, long long q_rs, long long q_cs, int32_t* out,
               long long n, const uint32_t* consts, cudaStream_t stream) {
  add_kernel<NW, DEG><<<blocks_for(n), kThreads, 0, stream>>>(
      p, p_rs, p_cs, q, q_rs, q_cs, out, n, unpack<NW, DEG>(consts));
  return (int)cudaGetLastError();
}

template <int NW, int DEG>
int launch_double(const int32_t* p, long long p_rs, long long p_cs,
                  int32_t* out, long long n, const uint32_t* consts,
                  cudaStream_t stream) {
  double_kernel<NW, DEG>
      <<<(unsigned)((n + 31) / 32), kDoubleThreads, 0, stream>>>(
          p, p_rs, p_cs, out, n, unpack<NW, DEG>(consts));
  return (int)cudaGetLastError();
}

template <int NW, int DEG>
int launch_horner(const int32_t* s, long long W, int c, int32_t* out,
                  const uint32_t* consts, cudaStream_t stream) {
  if (W < 2 || W > kHornerMaxW || c < 1) return (int)cudaErrorInvalidValue;
  horner_kernel<NW, DEG><<<1, 32, 0, stream>>>(s, (int)W, c, out,
                                               unpack<NW, DEG>(consts));
  return (int)cudaGetLastError();
}

template <int NW>
int launch_mont_chain(uint32_t* x, long long n, const uint32_t* consts,
                      cudaStream_t stream) {
  mont_chain_kernel<NW><<<1, 32, 0, stream>>>(x, n, unpack<NW, 1>(consts).f);
  return (int)cudaGetLastError();
}
#endif

}  // namespace dg16

#ifndef DG16_HOST_CHECK
// C entry points (bound with ctypes). `deg` is the coordinate field's
// extension degree (1: G1, 2: G2), `nw` the base field's 32-bit word count
// (8 for BN254). Each returns cudaGetLastError() after its launch.
extern "C" {

int dg16_limb_add(int deg, int nw, const int32_t* p, long long p_rs,
                  long long p_cs, const int32_t* q, long long q_rs,
                  long long q_cs, int32_t* out, long long n,
                  const uint32_t* consts, void* stream) {
  auto st = (cudaStream_t)stream;
  if (nw == 8 && deg == 1)
    return dg16::launch_add<8, 1>(p, p_rs, p_cs, q, q_rs, q_cs, out, n, consts, st);
  if (nw == 8 && deg == 2)
    return dg16::launch_add<8, 2>(p, p_rs, p_cs, q, q_rs, q_cs, out, n, consts, st);
  return (int)cudaErrorInvalidValue;
}

int dg16_limb_double(int deg, int nw, const int32_t* p, long long p_rs,
                     long long p_cs, int32_t* out, long long n,
                     const uint32_t* consts, void* stream) {
  auto st = (cudaStream_t)stream;
  if (nw == 8 && deg == 1)
    return dg16::launch_double<8, 1>(p, p_rs, p_cs, out, n, consts, st);
  if (nw == 8 && deg == 2)
    return dg16::launch_double<8, 2>(p, p_rs, p_cs, out, n, consts, st);
  return (int)cudaErrorInvalidValue;
}

int dg16_limb_horner(int deg, int nw, const int32_t* s, long long W, int c,
                     int32_t* out, const uint32_t* consts, void* stream) {
  auto st = (cudaStream_t)stream;
  if (nw == 8 && deg == 1)
    return dg16::launch_horner<8, 1>(s, W, c, out, consts, st);
  if (nw == 8 && deg == 2)
    return dg16::launch_horner<8, 2>(s, W, c, out, consts, st);
  return (int)cudaErrorInvalidValue;
}

// x: 32 elements of nw words in [0, 2p) on the card, each squared n times
// in place by its own lane; consts as for the G1 kernels.
int dg16_mont_chain(int nw, uint32_t* x, long long n, const uint32_t* consts,
                    void* stream) {
  if (nw == 8)
    return dg16::launch_mont_chain<8>(x, n, consts, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
#endif
