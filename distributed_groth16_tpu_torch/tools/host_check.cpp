// Host build of csrc/limb_group.cu for a logic check without a GPU.
//
// With DG16_HOST_CHECK the field core uses portable C++ with an emulated
// carry flag in place of its PTX; the shims below stand in for the CUDA
// built-ins. Kernels 1 and 2 run one point per loop iteration; Horner runs
// its warp as 32 host threads, __syncwarp() a barrier between them.
//
//   host_check <in.bin> <out.bin>
//
// in.bin (int32 little-endian): op (0 add, 1 double, 2 horner), deg, n (add
// and double: columns; horner: W), c (horner only, else 0), the consts
// words (2 * 8 + 8 * deg + 1), then the operands as contiguous
// int32[3 * 16 * deg, n] arrays (add: p, q; double: p; horner: s).
// out.bin: the result, int32[3 * 16 * deg, n] (horner: n = 1).
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
inline std::barrier<>* host_warp = nullptr;
inline void __syncwarp() { host_warp->arrive_and_wait(); }

#define DG16_HOST_CHECK
#include "../csrc/limb_group.cu"

template <int DEG>
static void run(int op, long long n, int c, const uint32_t* consts,
                const int32_t* data, int32_t* out) {
  constexpr int NW = 8, ROWS = 3 * 16 * DEG;
  const auto g = dg16::unpack<NW, DEG>(consts);
  if (op == 2) {
    std::barrier<> bar(32);
    host_warp = &bar;
    std::vector<std::thread> lanes;
    for (unsigned l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        threadIdx.x = l;
        dg16::horner_kernel<NW, DEG>(data, (int)n, c, out, g);
      });
    for (auto& t : lanes) t.join();
    return;
  }
  blockDim.x = 128;
  for (long long j = 0; j < n; ++j) {
    threadIdx.x = (unsigned)j;
    if (op == 0)
      dg16::add_kernel<NW, DEG>(data, n, 1, data + ROWS * n, n, 1, out, n, g);
    else
      dg16::double_kernel<NW, DEG>(data, n, 1, out, n, g);
  }
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  int32_t hdr[4];
  if (!f || std::fread(hdr, 4, 4, f) != 4) return 2;
  const int op = hdr[0], deg = hdr[1], c = hdr[3];
  const long long n = hdr[2];
  const int rows = 48 * deg;
  std::vector<uint32_t> consts(17 + 8 * deg);
  const long long cols = op == 0 ? 2 * n : n;
  std::vector<int32_t> data(rows * cols);
  if (std::fread(consts.data(), 4, consts.size(), f) != consts.size() ||
      std::fread(data.data(), 4, data.size(), f) != data.size())
    return 2;
  std::fclose(f);
  std::vector<int32_t> out(rows * (op == 2 ? 1 : n));
  if (deg == 1)
    run<1>(op, n, c, consts.data(), data.data(), out.data());
  else
    run<2>(op, n, c, consts.data(), data.data(), out.data());
  FILE* o = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), o);
  std::fclose(o);
  return 0;
}
