// PatchExpanding's pixel shuffle and LayerNorm in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves PatchExpanding's shuffle and
// LayerNorm to XLA, and its own LayerNorm kernel was deleted. It was added
// because the port ran the tail of PatchExpanding.forward (models/layers.py)
// as four memory-bound passes over the expand linear's output: the shuffle's
// copy, a cast of bf16 up to fp32, torch's LayerNorm (one block a row, so its
// cost follows rows and not bytes) and a cast back down. In a SwinWNet
// serving call the 11 expansions hold 71% of the LayerNorm rows, most of them
// in the SR head's two at c = 24 and c = 12.
//
// What it computes. y [B, H, W, 4c] (the linear's output, contiguous, in the
// compute type T: bf16 or fp32) and the LayerNorm's fp32 weight and bias [c]
// give out [B, 2H, 2W, c] in T:
//   out[b, 2h + p1, 2w + p2, :] = LN(y[b, h, w, k c : (k + 1) c]),  k = 2 p1 + p2.
// Statistics in fp32 (the mean, then the biased variance about it; eps 1e-5),
// the affine step in fp32, one rounding to T: torch's math but for the order
// of the fp32 sums. Read as rows, y is [4 B H W, c]: row r is part k = r % 4
// of token t = r / 4 = (b H + h) W + w, and it goes to output row
// (2 (b H + h) + p1) 2W + 2w + p2.
//
// Bound on the H100 (SXM, 3.35 TB/s): every element is read once and written
// once, 4 bytes an element in bf16 (8 in fp32), and its dozen operations are
// far below the card's rate, so the least time is 4 B H W 4c bytes over
// 3.35 TB/s. The four passes it replaces moved about 24 bytes an element.
//
// Design, for that bound:
//   * Lanes per row L, a power of two: the least that leaves a lane at most
//     NPL vectors of the row. The launcher reads c from the shape and picks
//     the vector width and L (bf16 rows of c = 12 and 24 take one thread, 48
//     two lanes, 96 four, 192 eight). One kernel; its vector width is a
//     template parameter, L a run-time one.
//   * Vectors of VB bytes: 16 where the row's bytes and both pointers allow,
//     else 8, 4 or 2 (a bf16 row of c = 12 is 24 bytes: 8-byte accesses).
//     Lane l of a row takes the row's vectors l, l + L, ..., so a row's lanes
//     read and write neighbouring bytes, and a warp's rows lie side by side
//     in y; each output row is one contiguous run.
//   * The row stays in registers from its load to its store: the mean, then
//     the variance about it, each summed over the lane's elements and over
//     the row's lanes with shuffles, then the affine step and the rounding.
//   * Weight and bias are read once a CTA into shared memory, as (w, b)
//     pairs, one 8-byte read an element.
//   * A grid-stride loop over the rows: as many CTAs of THREADS threads as
//     fit on the SMs at once (the occupancy calculator), each taking
//     THREADS / L rows a step.
// It launches on the caller's stream, allocates nothing and synchronises
// nothing, so a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NPL = 4;       // vectors a lane holds at most
constexpr int MAX_LANES = 32;
constexpr float EPS = 1e-5f;
constexpr long long MAX_TOKENS = 1LL << 28;

struct Bf16 {
  using S = unsigned short;  // the bits of a bf16
  static __device__ __forceinline__ float load(S s) { return __uint_as_float(static_cast<unsigned>(s) << 16); }
  static __device__ __forceinline__ S store(float f) { return __bfloat16_as_ushort(__float2bfloat16_rn(f)); }
};

struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S s) { return s; }
  static __device__ __forceinline__ S store(float f) { return f; }
};

template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// One vector: its bits as one load or store, its elements by index.
template <typename S, int VB>
union Pack {
  typename Raw<VB>::type raw;
  S e[VB / sizeof(S)];
};

__device__ __forceinline__ float row_sum(float s, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// rows = 4 B H W; W the input's token columns; L = 1 << lanes_log2.
template <typename E, int VB>
__global__ void __launch_bounds__(THREADS) expand_norm_kernel(const typename E::S* __restrict__ y,
                                                              typename E::S* __restrict__ out,
                                                              const float* __restrict__ weight,
                                                              const float* __restrict__ bias, int rows, int c,
                                                              int W, int lanes_log2) {
  using S = typename E::S;
  using R = typename Raw<VB>::type;
  constexpr int V = VB / sizeof(S);
  extern __shared__ float2 wb[];  // (weight, bias) of each column
  for (int i = threadIdx.x; i < c; i += THREADS) wb[i] = make_float2(weight[i], bias[i]);
  __syncthreads();

  const int L = 1 << lanes_log2, sub = threadIdx.x & (L - 1), nv = c / V;
  const int per_cta = THREADS >> lanes_log2;
  const float inv_c = 1.f / static_cast<float>(c);
  // the bound is the same for every thread of the CTA, so a warp's lanes
  // stay together for the shuffles; rows past the end compute on zeros
  for (int base = blockIdx.x * per_cta; base < rows; base += gridDim.x * per_cta) {
    const int row = base + (threadIdx.x >> lanes_log2);
    const bool live = row < rows;
    const R* src = reinterpret_cast<const R*>(y + static_cast<long long>(row) * c);
    float x[NPL][V];
    bool has[NPL];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      has[j] = live && j * L + sub < nv;
      Pack<S, VB> p;
      p.raw = has[j] ? __ldg(src + j * L + sub) : R();
#pragma unroll
      for (int i = 0; i < V; ++i) {
        x[j][i] = has[j] ? E::load(p.e[i]) : 0.f;
        sum += x[j][i];
      }
    }
    const float mean = row_sum(sum, L) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = x[j][i] - mean;
        sq += has[j] ? d * d : 0.f;
      }
    const float rstd = rsqrtf(row_sum(sq, L) * inv_c + EPS);
    if (!live) continue;
    const int t = row >> 2, k = row & 3, bh = t / W, w = t - bh * W;
    const long long orow = (2LL * bh + (k >> 1)) * (2LL * W) + 2 * w + (k & 1);
    R* dst = reinterpret_cast<R*>(out + orow * c);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      if (!has[j]) continue;
      const int v = j * L + sub;
      Pack<S, VB> p;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float2 g = wb[v * V + i];
        p.e[i] = E::store((x[j][i] - mean) * rstd * g.x + g.y);
      }
      dst[v] = p.raw;
    }
  }
}

template <typename E, int VB>
int launch(const void* y, void* out, const float* weight, const float* bias, int rows, int c, int W,
           int lanes_log2, cudaStream_t stream) {
  auto kernel = expand_norm_kernel<E, VB>;
  const size_t smem = sizeof(float2) * c;
  int dev = 0, sms = 0, ctas = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int per_cta = THREADS >> lanes_log2;
  const long long need = (static_cast<long long>(rows) + per_cta - 1) / per_cta;
  const long long fit = static_cast<long long>(sms) * (ctas > 0 ? ctas : 1);
  const int grid = static_cast<int>(need < fit ? need : fit);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const typename E::S*>(y), static_cast<typename E::S*>(out),
                                          weight, bias, rows, c, W, lanes_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one expansion on `stream`: y [tokens = B H W, 4c] to out
// [B, 2H, 2W, c], W the input's token columns. dtype: 0 = fp32, 1 = bf16.
// y and out contiguous, weight and bias [c] fp32. Returns 0, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take (the Python
// wrapper checks them first): a row wider than MAX_LANES * NPL vectors, or
// more than 2^28 tokens (the row index and the grid stride stay in an int).
int expand_norm_launch(int dtype, const void* y, void* out, const float* weight, const float* bias,
                       long long tokens, int W, int c, void* stream) {
  if ((dtype != 0 && dtype != 1) || tokens <= 0 || W <= 0 || tokens % W != 0 || c <= 0) return -1;
  if (tokens > MAX_TOKENS) return -1;
  const int item = dtype == 1 ? 2 : 4;
  // the widest vector that divides the row's bytes and both pointers' alignment
  const unsigned long long align = reinterpret_cast<unsigned long long>(y) | reinterpret_cast<unsigned long long>(out);
  int vb = 16;
  while (vb > item && ((c * item) % vb != 0 || align % vb != 0)) vb >>= 1;
  if ((c * item) % vb != 0 || align % vb != 0) return -1;
  const int nv = c * item / vb;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) * NPL < nv && (1 << lanes_log2) < MAX_LANES) ++lanes_log2;
  if ((1 << lanes_log2) * NPL < nv) return -1;
  const int rows = static_cast<int>(4 * tokens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (vb) {
      case 16: return launch<Bf16, 16>(y, out, weight, bias, rows, c, W, lanes_log2, s);
      case 8: return launch<Bf16, 8>(y, out, weight, bias, rows, c, W, lanes_log2, s);
      case 4: return launch<Bf16, 4>(y, out, weight, bias, rows, c, W, lanes_log2, s);
      default: return launch<Bf16, 2>(y, out, weight, bias, rows, c, W, lanes_log2, s);
    }
  }
  switch (vb) {
    case 16: return launch<F32, 16>(y, out, weight, bias, rows, c, W, lanes_log2, s);
    case 8: return launch<F32, 8>(y, out, weight, bias, rows, c, W, lanes_log2, s);
    default: return launch<F32, 4>(y, out, weight, bias, rows, c, W, lanes_log2, s);
  }
}

}  // extern "C"
