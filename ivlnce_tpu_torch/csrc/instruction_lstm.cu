// Instruction bi-LSTM over the changed rows of the per-episode cache (K5):
// ivlnce_tpu_torch/models/rnn.py::bi_lstm_rows on the card.
//
// It replaces no TPU kernel: the JAX package runs its instruction bi-LSTM
// (ivlnce_tpu/models/rnn.py bi_lstm_padded) as an XLA scan. It was added
// because the eval step re-encodes a few rows per step (the lanes whose
// episode changed), and cuDNN's LSTM made that a blocking read of the
// lengths, host loops over the distinct lengths to pack and unpack, and
// one small launch per token and direction, all issued while the card
// idled. Here one launch runs both directions of every changed row and
// writes the rows of the persistent (B, T, 2H) features in place.
//
// What bounds it on an H100: the chain of max-length dependent steps.
// Each step is a (rows x H) by (H x 4H) float32 product per direction,
// 2 * 4H * H operations per token and direction: at 256 rows of 0-200
// tokens (100 on average) about 6.7 GFLOP, 0.10 ms at the 67 TFLOP/s of
// the CUDA cores, but no step can start before the last one's h is
// known. The design:
//   - a block takes one direction and a tile of kRows rows, with 4H
//     threads; thread j owns gate column j (the gates [i, f, g, o] of
//     nn.LSTM) for the tile's rows, so each step's product is kRows
//     float32 FMA chains of length H per thread, h broadcast from shared
//     memory;
//   - W_hh comes in laid out [H][4H] (the wrapper's transposed copy):
//     neighbouring threads read neighbouring addresses. A direction's
//     W_hh is 256 KB at H = 128, more than a block's 227 KB of shared
//     memory, so it is read through L2 every step: both directions, 512
//     KB, stay resident there;
//   - the input pre-activations (both biases in) come from one matrix
//     product outside the kernel, once per change of the weights: a
//     table of every token's gates, which the kernel reads by the row's
//     token ids (RxR's features: one row per step, read in order). So an
//     encode is one upload and one launch: no gather, product or other
//     launch whose kernel the host would first have to load in the middle
//     of an eval. The step's input gates are loaded before the product,
//     which hides their latency; h lives in shared memory, c in the
//     registers of the thread that owns its (row, unit) pair;
//   - the forward direction walks t = 0 .. len - 1, the backward one
//     t = len - 1 .. 0 of each row's own length, as
//     models/rnn.py::bi_lstm_cells does; positions t >= len are zeroed
//     (a row that was longer before is cleared), and an empty row gets
//     zeros.
// Float32 throughout, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;             // rows per block
constexpr int kPairs = kRows / 4;    // (row, unit) pairs per thread
constexpr int kMaxThreads = 512;     // 4H, so H <= 128

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads) bi_lstm_rows_kernel(
    const float* __restrict__ gates, const long long* __restrict__ index,
    const float* __restrict__ w_hh_t, const long long* __restrict__ lengths,
    const long long* __restrict__ rows, float* __restrict__ out, int K,
    int Tg, int T, int H) {
  extern __shared__ float4 smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [kRows][H]
  float* g_s = h_s + kRows * H;                 // [kRows][4H]
  __shared__ int len_s[kRows];
  __shared__ long long row_s[kRows];
  const int G = 4 * H;
  const int j = threadIdx.x;
  const int dir = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int n = min(kRows, K - r0);
  if (j < kRows) {
    const long long len = j < n ? lengths[r0 + j] : 0;
    len_s[j] = (int)min(max(len, 0ll), (long long)Tg);
    row_s[j] = j < n ? rows[r0 + j] : 0;
  }
  for (int i = j; i < kRows * H; i += G) h_s[i] = 0.f;
  __syncthreads();
  int steps = 0;
  for (int r = 0; r < n; ++r) steps = max(steps, len_s[r]);
  const long long row_stride = (long long)T * 2 * H;
  // this direction's half of each row past its length
  for (int r = 0; r < n; ++r) {
    float* o = out + row_s[r] * row_stride + dir * H;
    for (int i = len_s[r] * H + j; i < T * H; i += G) {
      o[(long long)(i / H) * 2 * H + i % H] = 0.f;
    }
  }
  float c[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) c[q] = 0.f;
  const float* w = w_hh_t + (long long)dir * H * G + j;
  const float* gates_dir = gates + dir * G + j;
  for (int s = 0; s < steps; ++s) {
    float acc[kRows], gin[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] = 0.f;
      gin[r] = 0.f;
      if (r < n && s < len_s[r]) {
        const int t = dir ? len_s[r] - 1 - s : s;
        gin[r] = gates_dir[index[(long long)(r0 + r) * Tg + t] * 2 * G];
      }
    }
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      const float w0 = __ldg(w + (long long)k * G);
      const float w1 = __ldg(w + (long long)(k + 1) * G);
      const float w2 = __ldg(w + (long long)(k + 2) * G);
      const float w3 = __ldg(w + (long long)(k + 3) * G);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 h = *reinterpret_cast<const float4*>(h_s + r * H + k);
        acc[r] = fmaf(h.x, w0, acc[r]);
        acc[r] = fmaf(h.y, w1, acc[r]);
        acc[r] = fmaf(h.z, w2, acc[r]);
        acc[r] = fmaf(h.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < n && s < len_s[r]) g_s[r * G + j] = acc[r] + gin[r];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = j + q * G;
      const int r = p / H;
      const int u = p - r * H;
      if (r < n && s < len_s[r]) {
        const float* g = g_s + r * G;
        const float ig = sigmoid(g[u]);
        const float fg = sigmoid(g[H + u]);
        const float gg = tanhf(g[2 * H + u]);
        const float og = sigmoid(g[3 * H + u]);
        c[q] = fg * c[q] + ig * gg;
        const float h = og * tanhf(c[q]);
        h_s[r * H + u] = h;
        const int t = dir ? len_s[r] - 1 - s : s;
        out[row_s[r] * row_stride + (long long)t * 2 * H + dir * H + u] = h;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// gates (V, 8H): input pre-activations, forward gates then backward ones,
// b_ih + b_hh included; index (K, Tg): row r's step t reads
// gates[index[r][t]]; w_hh_t (2, H, 4H): each direction's W_hh
// transposed; lengths and rows (K,); out (B, T, 2H), rows rows[0..K)
// overwritten whole.
extern "C" int instruction_lstm_rows(
    const float* gates, const long long* index, const float* w_hh_t,
    const long long* lengths, const long long* rows, float* out, int K,
    int Tg, int T, int H, cudaStream_t stream) {
  if (H <= 0 || H % 8 != 0 || 4 * H > kMaxThreads || Tg > T) {
    return (int)cudaErrorInvalidValue;
  }
  if (K == 0) return 0;
  const dim3 grid((K + kRows - 1) / kRows, 2);
  const size_t smem = (size_t)5 * kRows * H * sizeof(float);
  bi_lstm_rows_kernel<<<grid, 4 * H, smem, stream>>>(
      gates, index, w_hh_t, lengths, rows, out, K, Tg, T, H);
  return (int)cudaGetLastError();
}

extern "C" const char* instruction_lstm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
