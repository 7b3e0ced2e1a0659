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
// What bounds it on the card: integer multiply-adds (one Montgomery
// product per butterfly per stage) against 128 bytes moved per element;
// shared memory keeps all stage intermediates on chip, so device memory
// is touched once on the way in and once on the way out.
#include "field.cuh"

namespace dg16 {

template <int NW>
__global__ void ntt_small_kernel(const int32_t* x, int32_t* out,
                                 const int32_t* tw, int S, int logS,
                                 long long L, int cpb,
                                 const FieldConsts<NW> c) {
  extern __shared__ uint32_t sm[];  // [cpb][S][NW]
  const long long l0 = (long long)blockIdx.x * cpb;
  const long long plane = (long long)S * L;  // stride between limb rows
  for (int idx = threadIdx.x; idx < cpb * S; idx += blockDim.x) {
    int col = idx % cpb, i = idx / cpb;
    long long l = l0 + col;
    uint32_t* dst = sm + ((long long)col * S + i) * NW;
    if (l < L) {
      int src = (int)(__brev((unsigned)i) >> (32 - logS));
      const int32_t* e = x + (long long)src * L + l;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        dst[w] = (uint32_t)e[(2 * w) * plane] |
                 ((uint32_t)e[(2 * w + 1) * plane] << 16);
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w) dst[w] = 0;
    }
  }
  __syncthreads();

  const int half = S / 2;
  const int col = threadIdx.x / half, b = threadIdx.x % half;
  const int tw_row = logS * half;  // stride between twiddle limb rows
  uint32_t* base = sm + (long long)col * S * NW;
  for (int s = 0; s < logS; ++s) {
    const int span = 1 << s;
    const int t = b & (span - 1);
    const int lo = ((b >> s) << (s + 1)) + t, hi = lo + span;
    uint32_t w[NW], a[NW], h[NW];
    const int32_t* twp = tw + s * half + t;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[k] = (uint32_t)twp[(2 * k) * tw_row] |
             ((uint32_t)twp[(2 * k + 1) * tw_row] << 16);
      a[k] = base[lo * NW + k];
      h[k] = base[hi * NW + k];
    }
    fp_mul<NW>(h, h, w, c);   // t = hi * w
    fp_sub<NW>(w, a, h, c);   // lo - t
    fp_add<NW>(a, a, h, c);   // lo + t
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      base[lo * NW + k] = a[k];
      base[hi * NW + k] = w[k];
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < cpb * S; idx += blockDim.x) {
    int col2 = idx % cpb, i = idx / cpb;
    long long l = l0 + col2;
    if (l >= L) continue;
    const uint32_t* v = sm + ((long long)col2 * S + i) * NW;
    int32_t* e = out + (long long)i * L + l;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      e[(2 * w) * plane] = (int32_t)(v[w] & 0xffffu);
      e[(2 * w + 1) * plane] = (int32_t)(v[w] >> 16);
    }
  }
}

}  // namespace dg16

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
  unsigned blocks = (unsigned)((L + cpb - 1) / cpb);
  size_t smem = (size_t)cpb * S * 8 * sizeof(uint32_t);
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
