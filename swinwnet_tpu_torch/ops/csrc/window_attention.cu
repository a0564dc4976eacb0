// The unfused Swin levels' window attention in bf16, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves this attention to XLA
// (swinwnet_tpu/models/layers.py WindowAttention, `attend_matmul`): on the
// TPU its fused block kernel takes every level it serves, and XLA fuses the
// rest. The port's levels above C = 96 in bf16 are not fused
// (BasicLayer.fused_route), and WindowAttention._attend ran their attention
// as a chain of PyTorch operations: q scaled, q, k and v cast up to fp32
// from permuted views, an fp32 SIMT product for the 25 x 25 scores, the bias
// in its own pass, the softmax, casts of the probabilities down and up, the
// second fp32 product, a cast and a copy out of the transpose, and at more
// than `attn_chunk` windows a split and a concatenation. That moved about 48
// bytes a token-channel and 36 a score through device memory. This kernel
// reads qkv once and writes the heads' output once, 8 bytes a
// token-channel.
//
// What it computes. qkv [Bw, n, 3C] bf16 (the qkv linear's output, channel
// s C + h hd + d for s = q, k, v), the relative-position bias [nH, n, n] fp32
// and the scale (hd^-0.5 rounded to bf16) give out [Bw, n, C] bf16, the
// layout `out.transpose(1, 2).reshape(Bw, n, C)` gives, for the output
// projection. _attend's arithmetic up to the order of fp32 sums: q times the
// scale rounded to bf16; scores as fp32 sums of bf16 products plus the fp32
// bias; the softmax in fp32 with expf and a correctly rounded division by
// the row's sum; the probabilities rounded to bf16; P.V summed in fp32 and
// rounded once to bf16. No mask: pad tokens take part as _attend has them.
//
// Bound on the H100 (SXM, 3.35 TB/s): 8 bytes a token-channel (6 read, 2
// written) against about 2 (n + hd) operations, far below the card's rate
// in bf16: bytes bound it.
//
// Design, for that bound:
//   * A unit is one window's q, k and v rows of a group of G heads, U = G hd
//     channels, U = min(C, 192): C = 384 takes two units a window. A CTA
//     keeps one group for its whole life, so a warp's head is fixed and its
//     bias stays in registers, as accumulator fragments (keys past the
//     window at -inf: the mask costs nothing).
//   * A CTA an SM (persistent), warp-specialised: 12 consumer warps, one a
//     (unit, head) of a step (a step is 12 / G units), and 4 producer warps
//     that copy. Steps go through a ring of shared memory (7 stages of one
//     unit at hd = 16, 3 of two at hd = 32, about 200 KB), filled by the
//     producers' 16-byte cp.async (a token's q, k and v are three runs of 2U
//     bytes, one of 6U where U = C, so every copy is coalesced) and counted
//     on the stage's mbarrier (cp.async.mbarrier.arrive). The consumers write
//     the heads' outputs to one of two output buffers, which the producers
//     store while the next step computes. A copy stalls the warp that issues
//     it until the memory system takes it, about as long as the arithmetic
//     of a step: with all warps copying and computing in turn, the kernel ran
//     1.7 to 2.8 times its bound; with the bulk copies of the TMA (a request
//     a token row of 384 to 1152 bytes) the requests themselves were the
//     bottleneck (2.1 to 4.1 times). Split so, copies overlap the arithmetic.
//   * A warp's products are mma.sync m16n8k16 bf16 -> fp32, the window's
//     rows padded to 32: S = Q.K^T in 2 x 4 tiles, hd / 16 deep; the softmax
//     on the accumulators with quad shuffles, the four row groups side by
//     side; P from the accumulators into the A operand of P.V; V through
//     ldmatrix.trans. A slot's token rows are 6U + 16 bytes apart and an
//     output buffer's 2U + 16, so ldmatrix and the output's stores read and
//     write no bank twice; the padded rows (tokens past the window) point
//     ldmatrix at one 16-byte zero vector.
// It launches on the caller's stream, allocates nothing and synchronises
// nothing, so a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 12;                      // the consumers: one a (unit, head) of a step
constexpr int PRODUCERS = 128;                 // threads of the copy warps
constexpr int THREADS = 32 * WARPS + PRODUCERS;
constexpr int UNIT_MAX = 192;       // channels of a unit at most
constexpr int MAX_N = 32;           // tokens of a window at most (two 16-row tiles)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_BUDGET = 230400;  // dynamic shared bytes at most (of 232,448 a CTA may opt in to)

struct Params {
  const bf16* qkv;
  bf16* out;
  const float* bias;
  long long windows, steps;  // steps = ceil(windows / units)
  int n, c, unit_c, group_heads, groups, units, stages, row_bytes, slot_bytes, out_row_bytes, out_bytes,
      ctas_per_group;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}
// an arrival on the barrier once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// waits for the completion of the barrier's phase of this parity; a wait
// that never ends (a fault in the pipeline) traps, so that the launch fails
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// both bf16 of a pair times `s`, each product rounded to bf16 (a bf16 tensor
// times a bf16 scalar in PyTorch)
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * s, f.y * s);
}

// A stage holds a step's units (windows j R + r, r < R) of the CTA's group:
// the step's token row i = r n + t at i * row_bytes, its q, k and v runs of
// 2U bytes each 0, 2U and 4U bytes in. An output buffer holds the step's
// heads' outputs, token rows of 2U bytes, out_row_bytes apart.

// The number of step j's units that lie before the end.
__device__ __forceinline__ int live_units(const Params& p, long long j) {
  const long long left = p.windows - j * p.units;
  return static_cast<int>(left < p.units ? left : p.units);
}

// Producer thread `pt` of PRODUCERS copies its 16-byte pieces of step j's
// rows into the stage at `stage`, then arrives on `bar` once they land.
__device__ __forceinline__ void load_step(const Params& p, uint32_t stage, uint32_t bar, long long j, int group,
                                          int pt) {
  const int U8 = p.unit_c / 8, per_row = 3 * U8, rows = live_units(p, j) * p.n;
  const bf16* src = p.qkv + j * p.units * p.n * 3 * p.c + group * p.unit_c;
  int row = pt / per_row, ch = pt - row * per_row;
  for (; row < rows;) {
    const int s = ch >= 2 * U8 ? 2 : ch >= U8 ? 1 : 0;  // q, k or v
    cp_async16(stage + row * p.row_bytes + ch * 16,
               src + static_cast<long long>(row) * 3 * p.c + s * p.c + (ch - s * U8) * 8);
    row += PRODUCERS / per_row;
    ch += PRODUCERS % per_row;
    if (ch >= per_row) ch -= per_row, ++row;
  }
  cp_async_arrive(bar);
}

// Producer thread `pt` stores its 16-byte pieces of step j's outputs from the
// output buffer at `buf`.
__device__ __forceinline__ void store_step(const Params& p, const unsigned char* buf, long long j, int group, int pt) {
  const int U8 = p.unit_c / 8, rows = live_units(p, j) * p.n;
  bf16* dst = p.out + j * p.units * p.n * p.c + group * p.unit_c;
  int row = pt / U8, ch = pt - row * U8;
  for (; row < rows;) {
    *reinterpret_cast<uint4*>(dst + static_cast<long long>(row) * p.c + ch * 8) =
        *reinterpret_cast<const uint4*>(buf + row * p.out_row_bytes + ch * 16);
    row += PRODUCERS / U8;
    ch += PRODUCERS % U8;
    if (ch >= U8) ch -= U8, ++row;
  }
}

// One warp's head `hl` of the unit in the slot at `slot`: scores, softmax and
// P.V in registers; the output into the unit's rows of the output buffer at
// `obuf`. `zero` is a 16-byte zero vector, the padded rows' operands.
template <int HD>
__device__ __forceinline__ void attend(const Params& p, uint32_t slot, unsigned char* obuf, int hl,
                                       const float (&bias)[2][4][4], uint32_t zero) {
  constexpr int KS = HD / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, n = p.n, rb = p.row_bytes, U2 = 2 * p.unit_c;
  const uint32_t base = slot + hl * HD * 2;

  uint32_t qa[2][KS][4];  // A fragments of q, scaled
  const int arow = lane & 15, acol = (lane >> 4) * 8;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int row = 16 * mt + arow;
      ldsm_x4(row < n ? base + row * rb + (16 * ks + acol) * 2 : zero, qa[mt][ks]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[mt][ks][i] = scale_pair(qa[mt][ks][i], p.scale);
    }

  float s[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
  const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t kb[4];  // B fragments of keys 16 np + [0, 16)
      const int key = 16 * np + krow;
      ldsm_x4(key < n ? base + U2 + key * rb + (16 * ks + kcol) * 2 : zero, kb);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(s[mt][2 * np], qa[mt][ks], kb[0], kb[1]);
        mma_bf16(s[mt][2 * np + 1], qa[mt][ks], kb[2], kb[3]);
      }
    }

  // the softmax of each row: a quad holds a row (elements 2 hf, 2 hf + 1 of
  // each tile), and the four row groups (mt, hf) go side by side
  float mx[2][2], sum[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[mt][hf] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[mt][nt][2 * hf + j] + bias[mt][nt][2 * hf + j];
          s[mt][nt][2 * hf + j] = x;
          mx[mt][hf] = fmaxf(mx[mt][hf], x);
        }
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) mx[mt][hf] = fmaxf(mx[mt][hf], __shfl_xor_sync(0xffffffffu, mx[mt][hf], o));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[mt][hf] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = expf(s[mt][nt][2 * hf + j] - mx[mt][hf]);
          s[mt][nt][2 * hf + j] = e;
          sum[mt][hf] += e;
        }
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) sum[mt][hf] += __shfl_xor_sync(0xffffffffu, sum[mt][hf], o);
  // e / sum correctly rounded (sum >= 1, e in [0, 1]): the quotient by the
  // correctly rounded reciprocal, then one correction (Markstein)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float rcp = __frcp_rn(sum[mt][hf]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = s[mt][nt][2 * hf + j], q = e * rcp;
          s[mt][nt][2 * hf + j] = fmaf(fmaf(-q, sum[mt][hf], e), rcp, q);
        }
    }
  uint32_t pa[2][2][4];  // A fragments of P, keys 16 ks + [0, 16)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      pa[mt][ks][0] = pack_bf16(s[mt][2 * ks][0], s[mt][2 * ks][1]);
      pa[mt][ks][1] = pack_bf16(s[mt][2 * ks][2], s[mt][2 * ks][3]);
      pa[mt][ks][2] = pack_bf16(s[mt][2 * ks + 1][0], s[mt][2 * ks + 1][1]);
      pa[mt][ks][3] = pack_bf16(s[mt][2 * ks + 1][2], s[mt][2 * ks + 1][3]);
    }

  float o[2][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3), vcol = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t vb[4];  // B fragments of v, tokens 16 ks + [0, 16), channels 16 dp + [0, 16)
      const int tok = 16 * ks + vrow;
      ldsm_x4_t(tok < n ? base + 2 * U2 + tok * rb + (16 * dp + vcol) * 2 : zero, vb);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(o[mt][2 * dp], pa[mt][ks], vb[0], vb[1]);
        mma_bf16(o[mt][2 * dp + 1], pa[mt][ks], vb[2], vb[3]);
      }
    }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * mt + 8 * hf + g;
      if (row >= n) continue;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(obuf + row * p.out_row_bytes + (hl * HD + 8 * nt + 2 * t) * 2) =
            pack_bf16(o[mt][nt][2 * hf], o[mt][nt][2 * hf + 1]);
    }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1) window_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  // full: a stage's copies have landed; empty: its products are done; out_full:
  // an output buffer is written; out_empty: it is stored
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], out_full[2], out_empty[2];
  __shared__ __align__(16) uint4 zero;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n = p.n;
  const int group = blockIdx.x % p.groups, cta = blockIdx.x / p.groups;
  if (threadIdx.x == 0) {
    zero = make_uint4(0, 0, 0, 0);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_addr(&full[s]), PRODUCERS);
      mbar_init(smem_addr(&empty[s]), WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_addr(&out_full[b]), WARPS);
      mbar_init(smem_addr(&out_empty[b]), PRODUCERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const uint32_t stages = smem_addr(smem);
  unsigned char* outs = smem + p.stages * p.units * p.slot_bytes;
  const long long cpg = p.ctas_per_group;
  const long long steps = cta < p.steps ? (p.steps - cta + cpg - 1) / cpg : 0;
  const int S = p.stages, stage_bytes = p.units * p.slot_bytes;

  if (warp >= WARPS) {  // the producers: copies in, S - 1 steps ahead, and outputs out
    const int pt = threadIdx.x - WARPS * 32;
    for (long long k = 0; k < S - 1 && k < steps; ++k)
      load_step(p, stages + k * stage_bytes, smem_addr(&full[k]), cta + k * cpg, group, pt);
    for (long long k = 1; k <= steps; ++k) {
      const int b = static_cast<int>((k - 1) & 1);
      mbar_wait(smem_addr(&out_full[b]), static_cast<uint32_t>(((k - 1) >> 1) & 1));
      store_step(p, outs + b * p.out_bytes, cta + (k - 1) * cpg, group, pt);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&out_empty[b]));
      const long long kn = k + S - 2;  // into the stage of step k - 2
      if (kn < steps) {
        const int sn = static_cast<int>(kn % S);
        mbar_wait(smem_addr(&empty[sn]), static_cast<uint32_t>(((kn / S) & 1) ^ 1));
        load_step(p, stages + sn * stage_bytes, smem_addr(&full[sn]), cta + kn * cpg, group, pt);
      }
    }
    return;
  }

  // the consumers: warp (r, hl) takes head hl of the step's unit r
  const int g = lane >> 2, t = lane & 3;
  const int r = warp / p.group_heads, hl = warp - r * p.group_heads;
  const int head = group * p.group_heads + hl;
  // the head's bias as accumulator fragments: keys past the window at -inf,
  // rows past it 0 (never stored)
  float bias[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + ((e >> 1) << 3), col = 8 * nt + 2 * t + (e & 1);
        bias[mt][nt][e] = col >= n ? -INFINITY
                          : row >= n ? 0.f
                                     : __ldg(p.bias + (static_cast<long long>(head) * n + row) * n + col);
      }
  for (long long k = 0; k < steps; ++k) {
    const int st = static_cast<int>(k % S), b = static_cast<int>(k & 1);
    mbar_wait(smem_addr(&full[st]), static_cast<uint32_t>((k / S) & 1));
    mbar_wait(smem_addr(&out_empty[b]), static_cast<uint32_t>(((k >> 1) & 1) ^ 1));
    if ((cta + k * cpg) * p.units + r < p.windows)
      attend<HD>(p, stages + st * stage_bytes + r * p.slot_bytes,
                 outs + b * p.out_bytes + r * n * p.out_row_bytes, hl, bias, smem_addr(&zero));
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(&empty[st]));
      mbar_arrive(smem_addr(&out_full[b]));
    }
  }
}

template <int HD>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  // above 48 KB only after opting in (per device, so at every launch)
  const cudaError_t e =
      cudaFuncSetAttribute(window_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The plan of a launch: out[0..5] = unit channels U, heads a unit G, units a
// step, groups a window, stages, shared bytes. Returns 0, or -1 for a shape
// the kernel does not take: a head width other than 16 or 32, more than 32
// tokens, C not a whole number of units, or 12 warps not a whole number of
// units' heads.
int plan_of(int n, int c, int heads, int* out) {
  if (n < 1 || n > MAX_N || heads < 1 || c % heads != 0) return -1;
  const int hd = c / heads;
  if (hd != 16 && hd != 32) return -1;
  const int unit_c = c < UNIT_MAX ? c : UNIT_MAX;
  if (c % unit_c != 0 || unit_c % hd != 0 || WARPS % (unit_c / hd) != 0) return -1;
  const int group_heads = unit_c / hd, units = WARPS / group_heads;
  const int slot_bytes = n * (6 * unit_c + 16), out_bytes = units * n * (2 * unit_c + 16);
  int stages = (SMEM_BUDGET - 2 * out_bytes) / (units * slot_bytes);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return -1;
  out[0] = unit_c;
  out[1] = group_heads;
  out[2] = units;
  out[3] = c / unit_c;
  out[4] = stages;
  out[5] = stages * units * slot_bytes + 2 * out_bytes;
  return 0;
}

}  // namespace

extern "C" {

// plan_of for the Python side, whose `takes` the card tests hold to it.
int window_attention_plan(int n, int c, int heads, int* out) { return plan_of(n, c, heads, out); }

// Launches the attention of `windows` windows on `stream`: qkv [windows, n,
// 3c] bf16 to out [windows, n, c] bf16, bias [heads, n, n] fp32, scale the
// bf16 value of hd^-0.5. qkv and out contiguous and 16-byte aligned. Returns
// 0, a cudaError_t from the launch, or -1 for arguments the kernel does not
// take.
int window_attention_launch(const void* qkv, void* out, const float* bias, long long windows, int n, int c,
                            int heads, float scale, void* stream) {
  int plan[6];
  if (windows <= 0 || plan_of(n, c, heads, plan) != 0) return -1;
  if ((reinterpret_cast<unsigned long long>(qkv) | reinterpret_cast<unsigned long long>(out)) % 16 != 0) return -1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.qkv = static_cast<const bf16*>(qkv);
  p.out = static_cast<bf16*>(out);
  p.bias = bias;
  p.windows = windows;
  p.n = n;
  p.c = c;
  p.unit_c = plan[0];
  p.group_heads = plan[1];
  p.units = plan[2];
  p.groups = plan[3];
  p.stages = plan[4];
  p.row_bytes = 6 * p.unit_c + 16;
  p.slot_bytes = n * p.row_bytes;
  p.out_row_bytes = 2 * p.unit_c + 16;
  p.out_bytes = p.units * n * p.out_row_bytes;
  p.steps = (windows + p.units - 1) / p.units;
  long long cpg = sms / p.groups;
  if (cpg < 1) cpg = 1;
  if (cpg > p.steps) cpg = p.steps;
  p.ctas_per_group = static_cast<int>(cpg);
  p.scale = scale;
  const int grid = p.ctas_per_group * p.groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c / heads == 16 ? launch<16>(p, grid, plan[5], s) : launch<32>(p, grid, plan[5], s);
}

}  // extern "C"
