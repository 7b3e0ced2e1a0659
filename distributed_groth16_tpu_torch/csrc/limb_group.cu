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
// CR = 16 (G1) or 32 (G2); rows X, Y, Z, each CR rows. One thread owns one
// point column: neighbouring threads read neighbouring addresses in every
// limb row, so each row load and store is coalesced. Inputs may be strided
// views (row stride, column stride), the ragged last block is masked,
// nothing is padded.
//
// What bounds them on the card: integer multiply-adds. A G1 add is 14
// Montgomery products (264 32-bit multiply-adds each) against 288 bytes
// moved per point, far above the H100's ops:byte balance, and G2 triples
// the products. The design keeps every intermediate in registers (no
// shared memory, no atomics); mont_mul is out of line (field.cuh), which
// keeps each kernel small enough to compile and, per ptxas -v, within
// 255 registers with at most a few bytes of spill.
//
// Horner (kernel 3) is a W-1 step dependency chain on a single point: one
// thread walks it and reads window column w directly (the TPU broadcast the
// point to 128 lanes and extracted the column by a masked lane reduce).
// It is latency-bound by construction and runs once per MSM.
#include "group.cuh"

namespace dg16 {

constexpr int kThreads = 128;

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

template <int NW, int DEG>
__global__ void __launch_bounds__(kThreads)
    double_kernel(const int32_t* p, long long p_rs, long long p_cs,
                  int32_t* out, long long n, const GroupConsts<NW, DEG> g) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t P[3 * NW * DEG];
  load_point<NW, DEG>(P, p, p_rs, j * p_cs);
  pt_double<NW, DEG>(P, P, g);
  store_point<NW, DEG>(out, n, j, P);
}

// acc = sum_w 2^(c*w) * S_w over the W columns of s (LSB window first).
template <int NW, int DEG>
__global__ void horner_kernel(const int32_t* s, long long W, int c,
                              int32_t* out, const GroupConsts<NW, DEG> g) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  uint32_t acc[3 * NW * DEG], col[3 * NW * DEG];
  load_point<NW, DEG>(acc, s, W, W - 1);
  for (long long w = W - 2; w >= 0; --w) {
    for (int k = 0; k < c; ++k) pt_double<NW, DEG>(acc, acc, g);
    load_point<NW, DEG>(col, s, W, w);
    pt_add<NW, DEG>(acc, acc, col, g);
  }
  store_point<NW, DEG>(out, 1, 0, acc);
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
  double_kernel<NW, DEG><<<blocks_for(n), kThreads, 0, stream>>>(
      p, p_rs, p_cs, out, n, unpack<NW, DEG>(consts));
  return (int)cudaGetLastError();
}

template <int NW, int DEG>
int launch_horner(const int32_t* s, long long W, int c, int32_t* out,
                  const uint32_t* consts, cudaStream_t stream) {
  horner_kernel<NW, DEG><<<1, 1, 0, stream>>>(s, W, c, out,
                                              unpack<NW, DEG>(consts));
  return (int)cudaGetLastError();
}

}  // namespace dg16

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

}  // extern "C"
