// Host build of csrc/limb_group.cu and csrc/ntt_small.cu for a logic check
// without a GPU.
//
// With DG16_HOST_CHECK the field core uses portable C++ with an emulated
// carry flag in place of its PTX; the shims below stand in for the CUDA
// built-ins. Kernel 1 runs one point per loop iteration. Kernels 2-4 run
// a block as one host thread per CUDA thread, block by block: Horner's
// __syncwarp() and kernel 4's __syncthreads() are barriers, and kernel 2's
// named barriers are barriers of the threads that meet there (an arrival
// does not wait).
//
//   host_check <in.bin> <out.bin>
//
// in.bin (int32 little-endian) starts with a header of 6 words:
//   op 0 add, 1 double, 2 horner: deg, n (columns; horner: W), c (horner,
//     else 0), cs (the input's column stride: it holds n * cs columns), 0;
//     then the consts words (2 * 8 + 8 * deg + 1) and the operands as
//     int32[3 * 16 * deg, n * cs] arrays (add: p, q; double: p; horner: s).
//     out.bin: int32[3 * 16 * deg, n] (horner: n = 1).
//   op 3 ntt_small: 0, S, L, cpb, 0; then the Fr consts (17 words), the
//     twiddle table int32[16, log2 S, S / 2] and x int32[16, S, L].
//     out.bin: int32[16, S, L].
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)

struct HostDim {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local HostDim threadIdx, blockIdx, blockDim;
inline std::barrier<>* host_warp = nullptr;   // the 32 lanes of a warp
inline std::barrier<>* host_block = nullptr;  // the threads of a block
inline std::barrier<>* host_named[4];         // kernel 2's named barriers
inline uint32_t* host_smem = nullptr;         // kernel 4's shared memory

inline void __syncwarp() { host_warp->arrive_and_wait(); }
inline void __syncthreads() { host_block->arrive_and_wait(); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}

#define DG16_HOST_CHECK
#include "../csrc/limb_group.cu"
#include "../csrc/ntt_small.cu"

namespace dg16 {
void bar_arrive(int id, int) { (void)host_named[id]->arrive(); }
void bar_wait(int id, int) { host_named[id]->arrive_and_wait(); }
}  // namespace dg16

// fn(t) on `threads` host threads, all started together
template <class F>
static void on_threads(unsigned threads, F fn) {
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t) ts.emplace_back(fn, t);
  for (auto& t : ts) t.join();
}

template <int DEG>
static void run_group(int op, long long n, int c, long long cs,
                      const uint32_t* consts, const int32_t* data,
                      int32_t* out) {
  constexpr int NW = 8, ROWS = 3 * 16 * DEG;
  const auto g = dg16::unpack<NW, DEG>(consts);
  std::barrier<> warp(32);
  host_warp = &warp;
  if (op == 0) {
    blockDim.x = dg16::kThreads;
    for (long long j = 0; j < n; ++j) {
      threadIdx.x = (unsigned)j;
      dg16::add_kernel<NW, DEG>(data, n, 1, data + ROWS * n, n, 1, out, n, g);
    }
  } else if (op == 1) {
    std::barrier<> z8(96), t0m(96), y3m(64), block(96);
    host_named[dg16::kHandZ8] = &z8;
    host_named[dg16::kHandT0m] = &t0m;
    host_named[dg16::kHandY3m] = &y3m;
    on_threads(dg16::kDoubleThreads, [&](unsigned t) {
      threadIdx.x = t;
      for (long long b = 0; b < (n + 31) / 32; ++b) {
        blockIdx.x = (unsigned)b;
        dg16::double_kernel<NW, DEG>(data, n * cs, cs, out, n, g);
        block.arrive_and_wait();  // the next block reuses the slot file
      }
    });
  } else {
    on_threads(32, [&](unsigned lane) {
      threadIdx.x = lane;
      dg16::horner_kernel<NW, DEG>(data, (int)n, c, out, g);
    });
  }
}

static void run_ntt(int S, long long L, int cpb, const uint32_t* consts,
                    const int32_t* tw, const int32_t* x, int32_t* out) {
  dg16::FieldConsts<8> c;
  for (int i = 0; i < 8; ++i) c.p[i] = consts[i];
  for (int i = 0; i < 8; ++i) c.p2[i] = consts[8 + i];
  c.n0 = consts[16];
  int logS = 0;
  while ((1 << logS) < S) ++logS;
  std::vector<uint32_t> smem(dg16::ntt_smem_bytes(S, cpb) / 4);
  host_smem = smem.data();
  const unsigned threads = (unsigned)(cpb * S / 2);
  std::barrier<> block(threads);
  host_block = &block;
  on_threads(threads, [&](unsigned t) {
    threadIdx.x = t;
    blockDim.x = threads;
    for (long long b = 0; b < (L + cpb - 1) / cpb; ++b) {
      blockIdx.x = (unsigned)b;
      dg16::ntt_small_kernel<8>(x, out, tw, S, logS, L, cpb, c);
      block.arrive_and_wait();  // the next block reuses the shared memory
    }
  });
}

template <class T>
static bool read(FILE* f, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), f) == v.size();
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  std::vector<int32_t> hdr(6);
  if (!f || !read(f, hdr)) return 2;
  const int op = hdr[0];
  std::vector<int32_t> out;
  if (op == 3) {
    const int S = hdr[2], cpb = hdr[4];
    const long long L = hdr[3];
    int logS = 0;
    while ((1 << logS) < S) ++logS;
    std::vector<uint32_t> consts(17);
    std::vector<int32_t> tw(16 * logS * (S / 2)), x(16 * S * L);
    if (!read(f, consts) || !read(f, tw) || !read(f, x)) return 2;
    out.resize(x.size());
    run_ntt(S, L, cpb, consts.data(), tw.data(), x.data(), out.data());
  } else {
    const int deg = hdr[1], c = hdr[3];
    const long long n = hdr[2], cs = hdr[4];
    const int rows = 48 * deg;
    std::vector<uint32_t> consts(17 + 8 * deg);
    std::vector<int32_t> data(rows * (op == 0 ? 2 * n : n * cs));
    if (!read(f, consts) || !read(f, data)) return 2;
    out.resize(rows * (op == 2 ? 1 : n));
    if (deg == 1)
      run_group<1>(op, n, c, cs, consts.data(), data.data(), out.data());
    else
      run_group<2>(op, n, c, cs, consts.data(), data.data(), out.data());
  }
  std::fclose(f);
  FILE* o = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), o);
  std::fclose(o);
  return 0;
}
