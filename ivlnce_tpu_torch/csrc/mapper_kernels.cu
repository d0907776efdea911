// Mapper kernels for Hopper (sm_90a): the world-grid accumulate (K1), the
// egocentric rasterize (K2) and the known-map load (K3) of
// ivlnce_tpu_torch/mapping/mapper.py.
//
// K1 replaces the JAX package's sort-based accumulate:
//   ivlnce_tpu/mapping/mapper.py:333 _accumulate_frame, :300 _flush_list,
//   ivlnce_tpu/ops/scatter.py:313 merge_points_into_list, :244 pack_aux,
//   :231 sortable_from_float, ivlnce_tpu/ops/geometry.py:125
//   depth_to_world_points.
// K2 replaces its sort-based rasterize:
//   ivlnce_tpu/mapping/mapper.py:393 _rasterize_egocentric,
//   ivlnce_tpu/ops/scatter.py:447 rasterize_occupancy_semantic_sorted,
//   :273 unpack_aux, :239 float_from_sortable, ivlnce_tpu/ops/geometry.py:191
//   egocentric_shift, :166 project_to_map_indices.
// K3 replaces its sort-based known-map load:
//   ivlnce_tpu/mapping/mapper.py:510 load_points_into_state,
//   ivlnce_tpu/ops/scatter.py:392 sorted_argmax_grid_update, :244 pack_aux,
//   :231 sortable_from_float.
//
// What bounds them on an H100: bytes. K1 reads 5 bytes per pixel (f32
// depth, u8 label) and does one 8-byte atomic per kept point into a grid
// far larger than L2 (12 MiB per lane at G = 1024), so it is bound by
// scattered 32-byte memory sectors, not by its ~40 flops per pixel. The
// design keeps it to two passes over the frame (max, then commit for the
// winners) and no intermediate buffers: the second pass recomputes the
// point instead of reading it back. K2 reads the 192^2 window of the grid
// (12 bytes per cell) and writes two u8 maps; the 64x64 map's candidate
// maxima stay in shared memory (32 KiB), so only the window read and the
// map write touch device memory. K3 is K1's two passes without the
// unprojection: it reads 13 bytes per point (f32 xyz, u8 label) and does
// one 8-byte atomic per point into the cleared grid, grid-striding over
// each cloud's real count rather than the padded capacity, so padding
// costs nothing.
//
// Arithmetic matches ivlnce_tpu_torch/ops/scatter.py's plain versions bit
// for bit: every float operation is an explicit round-to-nearest
// intrinsic, and fused multiply-adds appear exactly where the JAX
// reference's compiled form has them (see ops/geometry.py). Build with
// --fmad=false so the compiler adds none of its own.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQMax = 16383;
constexpr int kLaneAcc = 14;  // R (9), t (3), height lo, hi
constexpr int kLaneRas = 7;   // pose (3), cos, sin, height lo, hi
constexpr unsigned kIncumbentLow = 0xFFFFFFFFu;
constexpr unsigned long long kMaxWindowCells = 1ull << 20;

__device__ __forceinline__ int sortable_from_float(float x) {
  const int s = __float_as_int(x);
  return s >= 0 ? s : (s ^ 0x7FFFFFFF);
}

__device__ __forceinline__ float float_from_sortable(int k) {
  const int s = k >= 0 ? k : (k ^ 0x7FFFFFFF);
  return __int_as_float(s);
}

__device__ __forceinline__ long long make_word(int key, unsigned low) {
  return (long long)(((unsigned long long)(unsigned)key << 32) | low);
}

__device__ __forceinline__ int quantize(float v, int cell, float half,
                                        float inv_half) {
  // d = v - cell * h (no FMA), u = fma(d, 1/h, 0.5), q = round(u * Q)
  const float d = __fsub_rn(v, __fmul_rn((float)cell, half));
  const float u = __fmaf_rn(d, inv_half, 0.5f);
  const int q = __float2int_rn(__fmul_rn(u, (float)kQMax));
  return min(max(q, 0), kQMax);
}

struct FramePoint {
  bool valid;   // passed the depth and height windows
  bool inside;  // lies on the lane's grid
  long long cell;
  int key;
  int aux;
};

// One pixel's world point, filters, grid cell and packed payload.
__device__ __forceinline__ FramePoint frame_point(
    const float* __restrict__ depth, const uint8_t* __restrict__ sem,
    const float* __restrict__ lane, const int* __restrict__ origin,
    const float* __restrict__ rays_x, const float* __restrict__ rays_y,
    int b, int p, int H, int W, int G, float dmin, float dmax, float dscale,
    float half, float inv_half) {
  const int i = p / W;
  const int j = p - i * W;
  const size_t pix = (size_t)b * H * W + p;
  const float d = depth[pix];
  const float* L = lane + (size_t)b * kLaneAcc;
  const float x = __fmul_rn(d, rays_x[j]);
  const float y = __fmul_rn(d, rays_y[i]);
  const float z = __fmul_rn(d, dscale);
  // R @ (x, y, z) + t, three FMAs per row in index order
  const float wx = __fadd_rn(
      __fmaf_rn(L[2], z, __fmaf_rn(L[1], y, __fmul_rn(L[0], x))), L[9]);
  const float wy = __fadd_rn(
      __fmaf_rn(L[5], z, __fmaf_rn(L[4], y, __fmul_rn(L[3], x))), L[10]);
  const float wz = __fadd_rn(
      __fmaf_rn(L[8], z, __fmaf_rn(L[7], y, __fmul_rn(L[6], x))), L[11]);
  FramePoint out;
  out.valid = d > dmin && d < dmax && wy > L[12] && wy < L[13];
  const int r_abs = __float2int_rn(__fmul_rn(wz, inv_half));
  const int c_abs = __float2int_rn(__fmul_rn(wx, inv_half));
  const int r = r_abs - origin[2 * b];
  const int c = c_abs - origin[2 * b + 1];
  out.inside = r >= 0 && r < G && c >= 0 && c < G;
  out.cell = ((long long)b * G + r) * G + c;
  out.key = sortable_from_float(wy);
  out.aux = (quantize(wx, c_abs, half, inv_half) << 18) |
            (quantize(wz, r_abs, half, inv_half) << 4) | (sem[pix] & 0xF);
  return out;
}

// Pass 1: per cell, the 64-bit max of key << 32 | (0xFFFFFFFE - pixel).
// A stored point holds low word 0xFFFFFFFF and so wins equal keys.
__global__ void accumulate_max(
    long long* __restrict__ word, int* __restrict__ dropped,
    const float* __restrict__ depth, const uint8_t* __restrict__ sem,
    const float* __restrict__ lane, const int* __restrict__ origin,
    const float* __restrict__ rays_x, const float* __restrict__ rays_y,
    int H, int W, int G, float dmin, float dmax, float dscale, float half,
    float inv_half) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool lost = false;
  if (p < H * W) {
    const FramePoint fp = frame_point(depth, sem, lane, origin, rays_x,
                                      rays_y, b, p, H, W, G, dmin, dmax,
                                      dscale, half, inv_half);
    lost = fp.valid && !fp.inside;
    if (fp.valid && fp.inside) {
      atomicMax(word + fp.cell, make_word(fp.key, 0xFFFFFFFEu - (unsigned)p));
    }
  }
  const unsigned lost_mask = __ballot_sync(0xFFFFFFFFu, lost);
  if ((threadIdx.x & 31) == 0 && lost_mask != 0) {
    atomicAdd(dropped + b, __popc(lost_mask));
  }
}

// Pass 2: the pixel whose word survived writes its payload and becomes the
// cell's stored point.
__global__ void accumulate_commit(
    long long* __restrict__ word, int* __restrict__ aux,
    const float* __restrict__ depth, const uint8_t* __restrict__ sem,
    const float* __restrict__ lane, const int* __restrict__ origin,
    const float* __restrict__ rays_x, const float* __restrict__ rays_y,
    int H, int W, int G, float dmin, float dmax, float dscale, float half,
    float inv_half) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const FramePoint fp = frame_point(depth, sem, lane, origin, rays_x, rays_y,
                                    b, p, H, W, G, dmin, dmax, dscale, half,
                                    inv_half);
  if (!(fp.valid && fp.inside)) return;
  if (word[fp.cell] == make_word(fp.key, 0xFFFFFFFEu - (unsigned)p)) {
    aux[fp.cell] = fp.aux;
    word[fp.cell] = make_word(fp.key, kIncumbentLow);
  }
}

// One CTA per lane: the map's candidate maxima live in shared memory.
// Candidate word: nonfloor << 56 | (key ^ 2^31) << 24 |
// (2^20 - 1 - window index) << 4 | label; 0 = empty map cell.
__global__ void rasterize_kernel(
    const long long* __restrict__ word, const int* __restrict__ aux,
    const int* __restrict__ start, const int* __restrict__ origin,
    const float* __restrict__ lane, uint8_t* __restrict__ occupancy,
    uint8_t* __restrict__ semantic, int G, int window, int rows, int cols,
    float half, float rq, float half_h, float half_w, float inv_res) {
  extern __shared__ unsigned long long best[];
  const int b = blockIdx.x;
  const int n_map = rows * cols;
  for (int k = threadIdx.x; k < n_map; k += blockDim.x) best[k] = 0ull;
  __syncthreads();

  const int sr = start[2 * b];
  const int sc = start[2 * b + 1];
  const int orr = origin[2 * b];
  const int occ = origin[2 * b + 1];
  const float* L = lane + (size_t)b * kLaneRas;
  const float px = L[0], py = L[1], pz = L[2];
  const float cs = L[3], sn = L[4], lo = L[5], hi = L[6];
  const int n_win = window * window;
  for (int idx = threadIdx.x; idx < n_win; idx += blockDim.x) {
    const int i = idx / window;
    const int j = idx - i * window;
    const size_t g = ((size_t)b * G + (sr + i)) * G + (sc + j);
    const int key = (int)(word[g] >> 32);
    if (key == INT_MIN) continue;
    const float h = float_from_sortable(key);
    if (!(h > lo && h < hi)) continue;
    const int a = aux[g];
    const int qx = (a >> 18) & kQMax;
    const int qz = (a >> 4) & kQMax;
    const unsigned label = (unsigned)(a & 0xF);
    // (q / Q - 0.5) * h + cell * h as two FMAs
    const float x = __fmaf_rn(__fmaf_rn((float)qx, rq, -0.5f), half,
                              __fmul_rn((float)(sc + j + occ), half));
    const float z = __fmaf_rn(__fmaf_rn((float)qz, rq, -0.5f), half,
                              __fmul_rn((float)(sr + i + orr), half));
    const float sx = __fsub_rn(x, px);
    const float sy = __fsub_rn(h, py);
    const float sz = __fsub_rn(z, pz);
    // rotate by -heading: rows [c, 0, s] and [-s, 0, c], three FMAs each
    const float ex =
        __fmaf_rn(sn, sz, __fmaf_rn(0.0f, sy, __fmul_rn(cs, sx)));
    const float ez =
        __fmaf_rn(cs, sz, __fmaf_rn(0.0f, sy, __fmul_rn(-sn, sx)));
    const int mr = __float2int_rn(__fmul_rn(__fadd_rn(ez, half_h), inv_res));
    const int mc = __float2int_rn(__fmul_rn(__fadd_rn(ex, half_w), inv_res));
    if (mr < 0 || mr >= rows || mc < 0 || mc >= cols) continue;
    const unsigned long long cand =
        ((unsigned long long)(label != 0) << 56) |
        ((unsigned long long)((unsigned)key ^ 0x80000000u) << 24) |
        ((kMaxWindowCells - 1 - (unsigned long long)idx) << 4) | label;
    atomicMax(best + mr * cols + mc, cand);
  }
  __syncthreads();
  const size_t out = (size_t)b * n_map;
  for (int k = threadIdx.x; k < n_map; k += blockDim.x) {
    const unsigned long long v = best[k];
    occupancy[out + k] = v != 0ull;
    semantic[out + k] = ((v >> 56) & 1ull) ? (uint8_t)(v & 0xFull) : 0;
  }
}

// One known-map point (cloud l, index i): grid cell, key and payload.
struct KnownPoint {
  bool inside;
  long long cell;
  int key;
  int aux;
};

__device__ __forceinline__ KnownPoint known_point(
    const float* __restrict__ xyz, const uint8_t* __restrict__ sem,
    const int* __restrict__ rows, const int* __restrict__ origin, int l,
    int i, int N, int G, float half, float inv_half) {
  const size_t p = (size_t)l * N + i;
  const float x = xyz[3 * p];
  const float y = xyz[3 * p + 1];
  const float z = xyz[3 * p + 2];
  const int r_abs = __float2int_rn(__fmul_rn(z, inv_half));
  const int c_abs = __float2int_rn(__fmul_rn(x, inv_half));
  const int r = r_abs - origin[2 * l];
  const int c = c_abs - origin[2 * l + 1];
  KnownPoint out;
  out.inside = r >= 0 && r < G && c >= 0 && c < G;
  out.cell = ((long long)rows[l] * G + r) * G + c;
  out.key = sortable_from_float(y);
  out.aux = (quantize(x, c_abs, half, inv_half) << 18) |
            (quantize(z, r_abs, half, inv_half) << 4) | (sem[p] & 0xF);
  return out;
}

// K3 pass 1: per cell, the 64-bit max of key << 32 | (0xFFFFFFFE - i) over
// the cloud's first counts[l] points, grid-strided; points off the grid
// are summed per warp into dropped.
__global__ void known_load_max(
    long long* __restrict__ word, int* __restrict__ dropped,
    const int* __restrict__ rows, const int* __restrict__ origin,
    const float* __restrict__ xyz, const uint8_t* __restrict__ sem,
    const int* __restrict__ counts, int N, int G, float half,
    float inv_half) {
  const int l = blockIdx.y;
  const int count = min(counts[l], N);
  int lost = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const KnownPoint kp =
        known_point(xyz, sem, rows, origin, l, i, N, G, half, inv_half);
    if (kp.inside) {
      atomicMax(word + kp.cell, make_word(kp.key, 0xFFFFFFFEu - (unsigned)i));
    } else {
      ++lost;
    }
  }
  lost = __reduce_add_sync(0xFFFFFFFFu, lost);
  if ((threadIdx.x & 31) == 0 && lost != 0) {
    atomicAdd(dropped + rows[l], lost);
  }
}

// K3 pass 2: the point whose word survived writes its payload and becomes
// the cell's stored point.
__global__ void known_load_commit(
    long long* __restrict__ word, int* __restrict__ aux,
    const int* __restrict__ rows, const int* __restrict__ origin,
    const float* __restrict__ xyz, const uint8_t* __restrict__ sem,
    const int* __restrict__ counts, int N, int G, float half,
    float inv_half) {
  const int l = blockIdx.y;
  const int count = min(counts[l], N);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    const KnownPoint kp =
        known_point(xyz, sem, rows, origin, l, i, N, G, half, inv_half);
    if (kp.inside &&
        word[kp.cell] == make_word(kp.key, 0xFFFFFFFEu - (unsigned)i)) {
      aux[kp.cell] = kp.aux;
      word[kp.cell] = make_word(kp.key, kIncumbentLow);
    }
  }
}

}  // namespace

extern "C" int mapper_accumulate(
    long long* word, int* aux, int* dropped, const float* depth,
    const uint8_t* sem, const float* lane, const int* origin,
    const float* rays_x, const float* rays_y, int B, int H, int W, int G,
    float dmin, float dmax, float dscale, float half, float inv_half,
    cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((H * W + threads - 1) / threads, B);
  accumulate_max<<<grid, threads, 0, stream>>>(
      word, dropped, depth, sem, lane, origin, rays_x, rays_y, H, W, G, dmin,
      dmax, dscale, half, inv_half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  accumulate_commit<<<grid, threads, 0, stream>>>(
      word, aux, depth, sem, lane, origin, rays_x, rays_y, H, W, G, dmin,
      dmax, dscale, half, inv_half);
  return (int)cudaGetLastError();
}

extern "C" int mapper_rasterize(
    const long long* word, const int* aux, const int* start,
    const int* origin, const float* lane, uint8_t* occupancy,
    uint8_t* semantic, int B, int G, int window, int rows, int cols,
    float half, float rq, float half_h, float half_w, float inv_res,
    cudaStream_t stream) {
  const size_t smem = (size_t)rows * cols * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rasterize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rasterize_kernel<<<B, 1024, smem, stream>>>(
      word, aux, start, origin, lane, occupancy, semantic, G, window, rows,
      cols, half, rq, half_h, half_w, inv_res);
  return (int)cudaGetLastError();
}

extern "C" int mapper_known_load(
    long long* word, int* aux, int* dropped, const int* rows,
    const int* origin, const float* xyz, const uint8_t* sem,
    const int* counts, int L, int N, int G, float half, float inv_half,
    cudaStream_t stream) {
  if (L == 0) return 0;
  // up to 128 blocks per cloud, each thread striding over its points
  const int threads = 256;
  const dim3 grid(std::max(1, std::min((N + threads - 1) / threads, 128)),
                  L);
  known_load_max<<<grid, threads, 0, stream>>>(
      word, dropped, rows, origin, xyz, sem, counts, N, G, half, inv_half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  known_load_commit<<<grid, threads, 0, stream>>>(
      word, aux, rows, origin, xyz, sem, counts, N, G, half, inv_half);
  return (int)cudaGetLastError();
}

extern "C" const char* mapper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
