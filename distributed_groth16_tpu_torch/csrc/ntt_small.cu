// Kernel 4: batched radix-2 NTT over BN254 Fr of size S <= 256, the
// building block of the four-step limb NTT (ops/ntt_limb.py _ntt_rec).
//
// Replaces _SmallNTT._pallas of distributed_groth16_tpu/ops/ntt_limb.py
// (body _ntt_body). Same butterflies in the same order, same per-stage
// twiddle table (_stage_twiddles, int32[16, logS, S/2] Montgomery limbs),
// same redundant [0, 2p) arithmetic, so the output equals the plain
// PyTorch version limb for limb.
//
// x: int32[16, S, L] natural order, transform along axis 1, L independent
// columns. One block owns `cpb` columns: their S elements (8 words each)
// sit in shared memory, loaded through the bit-reversal permutation (the
// TPU applied it in XLA before its kernel), then log2(S) stages of S/2
// butterflies, one thread per butterfly, __syncthreads() between stages,
// and a natural-order store.
//
// What bounds it at its path shapes, (16, 256, 128) and (16, 128, 256), the
// two halves of a 2^15 transform: latency, and the device accesses around
// it. A launch has 16,384 butterflies a stage, 512 warps, about one per
// scheduler of the card's 132 SMs, so each stage costs one Montgomery
// product's latency and a barrier, and the log2(S) stages form a chain;
// the operations bound, which assumes a full card, is a fraction of that.
// A column is a stride-L walk through memory, so with few columns a block
// each 4-byte limb is a 32-byte sector of its own on the way in and out.
// The design:
//  - shared memory is laid out word-major, word k of element i of column
//    col at sm[(k * cpb + col) * S + i]: a warp's butterflies read 32
//    neighbouring words (stages >= 5) or words 2 apart (a 2-way bank
//    conflict at most), where an element-major layout made 8- to 16-way
//    conflicts on every word;
//  - the S - 1 twiddles the block uses (stage s's at offset 2^s - 1) are
//    staged in shared memory with the elements, instead of 16 scattered
//    device loads per butterfly in every stage; a thread issues all its
//    device loads (two elements, at most two twiddles) before it stores
//    any, one round trip;
//  - one butterfly a thread: two stages a barrier (radix 4) would halve
//    the threads, and with one warp per scheduler a thread's second
//    product waits for the multiply pipe rather than hiding a latency.
// PERF.md times the parent's kernel and the alternatives tried: radix 4,
// clusters of blocks that load and store whole sectors through
// distributed shared memory, stages 0 and log2(S) - 1 run from registers.
#include "field.cuh"

namespace dg16 {

// limbs 2k | 2k+1 << 16 of an element whose first limb is at e; limb rows
// are `plane` apart
template <int NW>
__device__ __forceinline__ void load_elem(uint32_t* v, const int32_t* e,
                                          long long plane, bool live) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    v[k] = live ? (uint32_t)e[(2 * k) * plane] |
                      ((uint32_t)e[(2 * k + 1) * plane] << 16)
                : 0u;
}

template <int NW>
__device__ __forceinline__ void store_elem(int32_t* e, long long plane,
                                           const uint32_t* v) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    e[(2 * k) * plane] = (int32_t)(v[k] & 0xffffu);
    e[(2 * k + 1) * plane] = (int32_t)(v[k] >> 16);
  }
}

template <int NW>
__global__ void ntt_small_kernel(const int32_t* x, int32_t* out,
                                 const int32_t* tw, int S, int logS,
                                 long long L, int cpb,
                                 const FieldConsts<NW> c) {
#ifdef DG16_HOST_CHECK
  uint32_t* sm = host_smem;
#else
  extern __shared__ uint32_t sm[];
#endif
  const int cs = cpb * S;          // words from one word plane to the next
  uint32_t* tws = sm + NW * cs;    // word k of twiddle e at tws[k * S + e]
  const int half = S / 2;
  const int tw_row = logS * half;  // stride between twiddle limb rows
  const long long l0 = (long long)blockIdx.x * cpb;
  const long long plane = (long long)S * L;  // stride between limb rows
  // blockDim = cs / 2: a thread loads elements idx = tid, tid + blockDim
  // (neighbouring threads on neighbouring columns) and twiddles e = tid,
  // tid + blockDim below S - 1
  uint32_t v[2][NW], u[2][NW];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = threadIdx.x + r * blockDim.x;
    const int src = (int)(__brev((unsigned)(idx / cpb)) >> (32 - logS));
    const long long l = l0 + idx % cpb;
    load_elem<NW>(v[r], x + (long long)src * L + l, plane, l < L);
    const int e = idx, s = 31 - __clz(e + 1), t = e + 1 - (1 << s);
    load_elem<NW>(u[r], tw + s * half + t, tw_row, e < S - 1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = threadIdx.x + r * blockDim.x;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      sm[k * cs + (idx % cpb) * S + idx / cpb] = v[r][k];
      if (idx < S - 1) tws[k * S + idx] = u[r][k];
    }
  }
  __syncthreads();

  const int col = threadIdx.x / half, b = threadIdx.x % half;
  uint32_t* base = sm + col * S;
  for (int s = 0; s < logS; ++s) {
    const int span = 1 << s;
    const int t = b & (span - 1);
    const int lo = ((b >> s) << (s + 1)) + t, hi = lo + span;
    uint32_t w[NW], a[NW], h[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[k] = tws[k * S + span - 1 + t];
      a[k] = base[k * cs + lo];
      h[k] = base[k * cs + hi];
    }
    fp_mul<NW>(h, h, w, c);  // t = hi * w
    fp_sub<NW>(w, a, h, c);  // lo - t
    fp_add<NW>(a, a, h, c);  // lo + t
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      base[k * cs + lo] = a[k];
      base[k * cs + hi] = w[k];
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = threadIdx.x + r * blockDim.x;
    const long long l = l0 + idx % cpb;
    const int i = idx / cpb;
    uint32_t o[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) o[k] = sm[k * cs + (idx % cpb) * S + i];
    if (l < L) store_elem<NW>(out + (long long)i * L + l, plane, o);
  }
}

// shared memory of a launch: the cpb columns' elements and the twiddles
inline size_t ntt_smem_bytes(int S, int cpb) {
  return (size_t)(cpb + 1) * S * 8 * sizeof(uint32_t);
}

}  // namespace dg16

#ifndef DG16_HOST_CHECK
extern "C" {

// consts: words p[8], 2p[8], n0 of Fr. Threads per block: cpb * S / 2.
int dg16_ntt_small(const int32_t* x, int32_t* out, const int32_t* tw, int S,
                   int logS, long long L, int cpb, const uint32_t* consts,
                   void* stream) {
  if (S < 2 || S > 256 || (1 << logS) != S || cpb < 1 || cpb * S / 2 > 1024)
    return (int)cudaErrorInvalidValue;
  dg16::FieldConsts<8> c;
  for (int i = 0; i < 8; ++i) c.p[i] = consts[i];
  for (int i = 0; i < 8; ++i) c.p2[i] = consts[8 + i];
  c.n0 = consts[16];
  const unsigned blocks = (unsigned)((L + cpb - 1) / cpb);
  const size_t smem = dg16::ntt_smem_bytes(S, cpb);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(dg16::ntt_small_kernel<8>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  dg16::ntt_small_kernel<8><<<blocks, cpb * S / 2, smem,
                              (cudaStream_t)stream>>>(x, out, tw, S, logS, L,
                                                      cpb, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
