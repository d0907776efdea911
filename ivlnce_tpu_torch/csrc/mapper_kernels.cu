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
// What bounds them on an H100: bytes, and the latency of scattered ones.
//
// K1 (mapper_accumulate) reads 5 bytes per pixel (f32 depth, u8 label)
// and must settle one 64-bit max per distinct grid cell in a grid far
// larger than L2 (12 MiB per lane at G = 1024), at ~40 flops per pixel.
// A first design gave each pixel a thread and a global atomicMax, then
// reread the frame to commit the winners. It was latency-bound (one load
// per thread in flight), and on rendered frames, where a wall column's
// pixels share one cell, its atomics serialized in L2. The tile design:
//   - a block of 8 warps takes a 32 x 32 tile of the frame; each thread
//     holds one column's 4 rows, their 8 loads in flight at once;
//   - candidates are elected in registers before global memory: among
//     the thread's 4 rows one survivor per cell (the highest word), then,
//     per row of the warp, a survivor drops out when its left or right
//     neighbour (two shuffles) holds the same cell and a higher word. A
//     wall column's pixels share a cell down the column, and a near
//     wall's or floor's along the row, so on rendered frames most pixels
//     drop out; on noise nothing merges and the election costs a few
//     instructions;
//   - only candidates issue the global atomicMax, and its result is not
//     read, so it is a fire-and-forget reduction in L2;
//   - each warp stores its candidates as 4 ballots (16 bytes) in a scratch
//     buffer the wrapper allocates; the commit pass (a second launch, same
//     grid) reloads the tile's rows, a likely L2 hit, and only candidates
//     compute their point and read the grid word, all 4 reads in flight.
// Two launches order the passes more cheaply than a cooperative grid sync
// would: at B = 64 the 4096 tiles cannot all be resident. Combining in
// shared memory cost more than it saved where nothing merges: with a
// 1024-slot shared hash table, or with __match_any_sync over 32 distinct
// cells, the max pass on noise frames took 0.10 or 0.083 ms at B = 64
// against the first design's 0.035 ms (chip_smoke.py phase 4, H100). The
// 64-bit max is associative and commutative, so reducing within a thread,
// then a warp, then in global memory gives the same word per cell as one
// global atomic per pixel; a pixel that lost to a candidate of its own
// cell cannot win globally, so committing only candidates commits every
// winner.
//
// K2 (mapper_rasterize) reads the 192^2 window of the grid (8-byte words,
// and the payload of each stored point in the height window) and writes
// two u8 maps. A first design ran one block per lane: 64 of 132 SMs at
// B = 64, 3 at the evaluation's 3 lanes, each thread walking 36 cells
// with a dependent word-then-payload load. The cluster design splits each
// lane's window over a thread-block cluster of 8 blocks (24 rows each at
// window 192; a ragged window leaves the last blocks fewer rows or none),
// 512 threads each. A thread issues the key loads (the high halves of the
// words) of all its cells at once, then the payload loads of those in the
// height window: two round trips to memory per thread. Each block keeps
// its own 64 x 64 candidate map (32 KiB) in shared memory; neighbouring
// window cells that land in one map cell are merged by two shuffles
// first, so fewer 64-bit shared atomics contend for an address. After
// cluster.sync() each block reduces one eighth of the map cells over all
// eight copies through distributed shared memory and writes them; a final
// cluster.sync() keeps every block's map alive while its peers read it.
//
// K3 (mapper_known_load) overwrites each loaded row whole: the row is
// cleared and each cell's winner among the cloud's points is written, as
// the JAX function clears the lane and then loads it. It must move the
// row (12 bytes per cell: 805 MB for 64 rows of 1024^2) and the cloud
// (13 bytes per point). The points' cells are random in a grid far larger
// than L2, so a design that settles them in device memory pays a
// scattered 32-byte sector per point and per pass: the first design (one
// global atomicMax per point into a grid cleared beforehand by the
// caller, then a reread of the cloud and the grid to commit the winners;
// deleted once the tiled design was measured against it) took 2.4x as
// long at B=64 x 2^18 points. The tiled design bins the
// points by 64 x 64 tile of the row and settles each tile in shared
// memory, in two launches:
//   1. scatter (known_bin_scatter): one block per chunk of 2048 points,
//      8 per thread with all their loads in flight, sorts the chunk's
//      points on the grid by tile in shared memory (a counting sort) and
//      writes them as 16-byte records (the low word 0xFFFFFFFE - i, the
//      height key, the payload, the cell within the tile) to the chunk's
//      own part of the bins, in one contiguous store; each tile's run in
//      the chunk (start, length) goes to a table. Points off the grid are
//      summed per warp into dropped;
//   2. tile (known_tile_load): one block per (lane, tile) starts a shared
//      tile of empty words and zero payloads (48 KiB), gathers its runs
//      from every chunk (their lengths scanned in shared memory: glue over
//      chunks integers), takes the 64-bit max of its records' words with
//      shared atomics, sweeps the records again (L2 hits) so that the
//      record holding its cell's max writes the payload, and writes the
//      whole tile, the clear included, with 16-byte streaming stores (per
//      cell where the tile is ragged).
// Two earlier forms of this design lost (chip_smoke.py phase 4, H100, B =
// 64): a count pass over the cloud, a scan, then a scatter of each point's
// record straight to its tile's bin (one per point in point order: a
// warp's 32 stores fell on up to 32 bins, and L2 evicted the sectors half
// filled) took 0.655 ms for the scatter alone; sorting each chunk by tile
// first cut that to 0.278, and the count pass's second read of the cloud
// cost 0.078 more. Here the cloud is read once and the bins written in
// order.
// The row is written once and coalesced, the cloud read once, the bins
// (16 bytes per point on the grid) written and read once. The 64-bit
// max is associative and commutative, so the order in which a tile meets
// its records changes no word, and equal keys still go to the lowest
// index. A point whose key equals EMPTY_KEY never beats the empty word,
// so its cell stays empty. A tile's block loops over its records however
// many: a skewed cloud puts a quarter of its points in a few tiles.
//
// Tie rules, kept by every version: a stored point holds low word
// 0xFFFFFFFF and so wins an equal key; among a frame's new points the
// lowest pixel wins (low word 0xFFFFFFFE - pixel); in the raster the
// lowest window index wins.
//
// Arithmetic matches ivlnce_tpu_torch/ops/scatter.py's plain versions bit
// for bit: every float operation is an explicit round-to-nearest
// intrinsic, and fused multiply-adds appear exactly where the JAX
// reference's compiled form has them (see ops/geometry.py). Build with
// --fmad=false so the compiler adds none of its own.

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQMax = 16383;
constexpr int kLaneAcc = 14;  // R (9), t (3), height lo, hi
constexpr int kLaneRas = 7;   // pose (3), cos, sin, height lo, hi
constexpr unsigned kIncumbentLow = 0xFFFFFFFFu;
constexpr unsigned long long kMaxWindowCells = 1ull << 20;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// K1 tile design
constexpr int kTileW = 32;  // a warp's lanes: one tile column each
constexpr int kRowsPerThread = 4;
constexpr int kTileWarps = 8;
constexpr int kTileH = kTileWarps * kRowsPerThread;
constexpr int kTileThreads = kTileWarps * 32;
static_assert(kRowsPerThread == 4, "a warp's ballots are stored as a uint4");
constexpr unsigned kNoCell = 0xFFFFFFFFu;  // above any cell id r * G + c

// K2 cluster design
constexpr int kRasterCluster = 8;
constexpr int kRasterThreads = 512;
// every cell of a 192-cell window's band (24 rows) has its loads in flight
// at once: 24 * 192 / 512 = 9 per thread
constexpr int kRasterUnroll = 9;

// K3 tiled design
constexpr int kKnownThreads = 256;
constexpr int kKnownTileShift = 6;  // 64 x 64 cells per tile
constexpr int kKnownTile = 1 << kKnownTileShift;
constexpr int kKnownTileCells = kKnownTile * kKnownTile;
// a tile's shared words and payloads: 32 KiB + 16 KiB
constexpr size_t kKnownTileSmem =
    kKnownTileCells * (sizeof(long long) + sizeof(int));
constexpr int kKnownRecordUnroll = 4;  // records in flight per thread
// the scatter pass takes each cloud in chunks of 2048 points, one block
// each, 8 per thread with all their loads in flight
constexpr int kKnownChunkPerThread = 8;
constexpr int kKnownChunk = kKnownThreads * kKnownChunkPerThread;
constexpr int kKnownTileThreads = 512;
constexpr long long kEmptyWord =
    (long long)(((unsigned long long)0x80000000u << 32) | 0xFFFFFFFFull);

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

// One pixel's world point, filters, grid cell and packed payload, from
// its depth d and label at row i, column j of lane b's frame.
__device__ __forceinline__ FramePoint frame_point_of(
    float d, uint8_t label, const float* __restrict__ lane,
    const int* __restrict__ origin, const float* __restrict__ rays_x,
    const float* __restrict__ rays_y, int b, int i, int j, int G,
    float dmin, float dmax, float dscale, float half, float inv_half) {
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
            (quantize(wz, r_abs, half, inv_half) << 4) | (label & 0xF);
  return out;
}

// ---------------------------------------------------------------------------
// K1, tile design: candidates elected within the thread and the warp, a
// global atomic per candidate, then the candidates' commit.
// ---------------------------------------------------------------------------

// This thread's pixels of tile (blockIdx.x, blockIdx.y) of lane b's frame:
// column j, rows i0 .. i0 + kRowsPerThread - 1, their depths and labels
// loaded all at once.
struct TileRows {
  int j, i0;
  bool in[kRowsPerThread];
  float d[kRowsPerThread];
  uint8_t label[kRowsPerThread];
};

__device__ __forceinline__ TileRows load_tile_rows(
    const float* __restrict__ depth, const uint8_t* __restrict__ sem, int b,
    int H, int W) {
  TileRows t;
  t.j = blockIdx.x * kTileW + (threadIdx.x & 31);
  t.i0 = blockIdx.y * kTileH + (threadIdx.x >> 5) * kRowsPerThread;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = t.i0 + k;
    t.in[k] = i < H && t.j < W;
    const size_t pix = ((size_t)b * H + i) * W + t.j;
    t.d[k] = t.in[k] ? depth[pix] : 0.0f;
    t.label[k] = t.in[k] ? sem[pix] : 0;
  }
  return t;
}

// Index of this warp's candidate ballots (one uint4 per warp and tile).
__device__ __forceinline__ size_t ballot_index(int b) {
  return (((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
             kTileWarps + (threadIdx.x >> 5);
}

// Pass 1. Grid (tiles across, tiles down, lanes). A pixel is a candidate
// when it holds the highest word of its cell among the thread's rows and
// then among its warp's row; each candidate does a global atomicMax whose
// result is not read.
__global__ void __launch_bounds__(kTileThreads) accumulate_tile_max(
    long long* __restrict__ word, int* __restrict__ dropped,
    uint4* __restrict__ ballots, const float* __restrict__ depth,
    const uint8_t* __restrict__ sem, const float* __restrict__ lane,
    const int* __restrict__ origin, const float* __restrict__ rays_x,
    const float* __restrict__ rays_y, int H, int W, int G, float dmin,
    float dmax, float dscale, float half, float inv_half) {
  const int b = blockIdx.z;
  const long long lane_cells = (long long)b * G * G;
  const TileRows t = load_tile_rows(depth, sem, b, H, W);
  FramePoint fp[kRowsPerThread];
  long long mine[kRowsPerThread];
  bool keep[kRowsPerThread];
  int lost = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = t.i0 + k;
    // rows and columns past a ragged frame edge read no ray
    fp[k] = t.in[k] ? frame_point_of(t.d[k], t.label[k], lane, origin,
                                     rays_x, rays_y, b, i, t.j, G, dmin,
                                     dmax, dscale, half, inv_half)
                    : FramePoint{};
    keep[k] = fp[k].valid && fp[k].inside;
    lost += fp[k].valid && !fp[k].inside;
    mine[k] = make_word(fp[k].key, 0xFFFFFFFEu - (unsigned)(i * W + t.j));
  }
  // one survivor per cell among the thread's rows: the highest word
#pragma unroll
  for (int k = 1; k < kRowsPerThread; ++k) {
#pragma unroll
    for (int m = 0; m < k; ++m) {
      if (keep[k] && keep[m] && fp[k].cell == fp[m].cell) {
        if (mine[k] > mine[m]) {
          keep[m] = false;
        } else {
          keep[k] = false;
        }
      }
    }
  }
  // per row of the warp, a survivor whose left or right neighbour holds
  // the same cell and a higher word drops out (lanes 0 and 31 see their
  // own values, never higher): a run of pixels in one cell keeps its
  // local maxima, one where heights along the row are monotone
  unsigned lead_mask[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const unsigned cell =
        keep[k] ? (unsigned)(fp[k].cell - lane_cells) : kNoCell;
    const unsigned left_cell = __shfl_up_sync(kFullMask, cell, 1);
    const long long left = __shfl_up_sync(kFullMask, mine[k], 1);
    const unsigned right_cell = __shfl_down_sync(kFullMask, cell, 1);
    const long long right = __shfl_down_sync(kFullMask, mine[k], 1);
    const bool lead = keep[k] && !(left_cell == cell && left > mine[k]) &&
                      !(right_cell == cell && right > mine[k]);
    if (lead) atomicMax(word + fp[k].cell, mine[k]);
    lead_mask[k] = __ballot_sync(kFullMask, lead);
  }
  lost = __reduce_add_sync(kFullMask, lost);
  if ((threadIdx.x & 31) == 0) {
    if (lost != 0) atomicAdd(dropped + b, lost);
    ballots[ballot_index(b)] =
        make_uint4(lead_mask[0], lead_mask[1], lead_mask[2], lead_mask[3]);
  }
}

// Pass 2, same grid: a candidate whose word survived writes its payload
// and becomes the cell's stored point. Only candidates compute their point
// and read the grid.
__global__ void __launch_bounds__(kTileThreads) accumulate_tile_commit(
    long long* __restrict__ word, int* __restrict__ aux,
    const uint4* __restrict__ ballots, const float* __restrict__ depth,
    const uint8_t* __restrict__ sem, const float* __restrict__ lane,
    const int* __restrict__ origin, const float* __restrict__ rays_x,
    const float* __restrict__ rays_y, int H, int W, int G, float dmin,
    float dmax, float dscale, float half, float inv_half) {
  const int b = blockIdx.z;
  const uint4 m = ballots[ballot_index(b)];
  const TileRows t = load_tile_rows(depth, sem, b, H, W);
  const unsigned lead_mask[kRowsPerThread] = {m.x, m.y, m.z, m.w};
  // a thread's candidates lie in distinct cells, so all their grid words
  // can be read before any is written
  FramePoint fp[kRowsPerThread];
  long long mine[kRowsPerThread], now[kRowsPerThread];
  bool cand[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int i = t.i0 + k;
    cand[k] = (lead_mask[k] >> (threadIdx.x & 31)) & 1u;
    fp[k] = cand[k] ? frame_point_of(t.d[k], t.label[k], lane, origin,
                                     rays_x, rays_y, b, i, t.j, G, dmin,
                                     dmax, dscale, half, inv_half)
                    : FramePoint{};
    mine[k] = make_word(fp[k].key, 0xFFFFFFFEu - (unsigned)(i * W + t.j));
    now[k] = cand[k] ? word[fp[k].cell] : 0;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    if (cand[k] && now[k] == mine[k]) {
      aux[fp[k].cell] = fp[k].aux;
      word[fp[k].cell] = make_word(fp[k].key, kIncumbentLow);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: shared per-lane constants and the placement of one stored point.
// ---------------------------------------------------------------------------
struct RasterLane {
  int sr, sc;    // window corner in the grid
  int orr, occ;  // grid origin in absolute half-resolution cells
  float px, py, pz, cs, sn, lo, hi;
};

__device__ __forceinline__ RasterLane raster_lane(
    const int* __restrict__ start, const int* __restrict__ origin,
    const float* __restrict__ lane, int b) {
  const float* L = lane + (size_t)b * kLaneRas;
  RasterLane r;
  r.sr = start[2 * b];
  r.sc = start[2 * b + 1];
  r.orr = origin[2 * b];
  r.occ = origin[2 * b + 1];
  r.px = L[0];
  r.py = L[1];
  r.pz = L[2];
  r.cs = L[3];
  r.sn = L[4];
  r.lo = L[5];
  r.hi = L[6];
  return r;
}

__device__ __forceinline__ bool in_height(const RasterLane& L, int key) {
  if (key == INT_MIN) return false;
  const float h = float_from_sortable(key);
  return h > L.lo && h < L.hi;
}

// Window cell (i, j), index idx, holding a stored point of height key
// `key` and payload `a`: its map cell, or -1 off the map, and its
// candidate word nonfloor << 56 | (key ^ 2^31) << 24 |
// (2^20 - 1 - idx) << 4 | label (0 = empty map cell).
__device__ __forceinline__ int raster_place(
    const RasterLane& L, int i, int j, int idx, int key, int a, int rows,
    int cols, float half, float rq, float half_h, float half_w,
    float inv_res, unsigned long long* cand) {
  const float h = float_from_sortable(key);
  const int qx = (a >> 18) & kQMax;
  const int qz = (a >> 4) & kQMax;
  const unsigned label = (unsigned)(a & 0xF);
  // (q / Q - 0.5) * h + cell * h as two FMAs
  const float x = __fmaf_rn(__fmaf_rn((float)qx, rq, -0.5f), half,
                            __fmul_rn((float)(L.sc + j + L.occ), half));
  const float z = __fmaf_rn(__fmaf_rn((float)qz, rq, -0.5f), half,
                            __fmul_rn((float)(L.sr + i + L.orr), half));
  const float sx = __fsub_rn(x, L.px);
  const float sy = __fsub_rn(h, L.py);
  const float sz = __fsub_rn(z, L.pz);
  // rotate by -heading: rows [c, 0, s] and [-s, 0, c], three FMAs each
  const float ex =
      __fmaf_rn(L.sn, sz, __fmaf_rn(0.0f, sy, __fmul_rn(L.cs, sx)));
  const float ez =
      __fmaf_rn(L.cs, sz, __fmaf_rn(0.0f, sy, __fmul_rn(-L.sn, sx)));
  const int mr = __float2int_rn(__fmul_rn(__fadd_rn(ez, half_h), inv_res));
  const int mc = __float2int_rn(__fmul_rn(__fadd_rn(ex, half_w), inv_res));
  if (mr < 0 || mr >= rows || mc < 0 || mc >= cols) return -1;
  *cand = ((unsigned long long)(label != 0) << 56) |
          ((unsigned long long)((unsigned)key ^ 0x80000000u) << 24) |
          ((kMaxWindowCells - 1 - (unsigned long long)idx) << 4) | label;
  return mr * cols + mc;
}

__device__ __forceinline__ void write_map_cell(
    unsigned long long v, size_t k, uint8_t* __restrict__ occupancy,
    uint8_t* __restrict__ semantic) {
  occupancy[k] = v != 0ull;
  semantic[k] = ((v >> 56) & 1ull) ? (uint8_t)(v & 0xFull) : 0;
}

// K2, cluster design: grid (8, lanes), one cluster of 8 blocks per lane.
// Block `rank` takes window rows [rank * band, (rank + 1) * band) and
// map cells [rank * share, (rank + 1) * share).
__global__ void __cluster_dims__(kRasterCluster, 1, 1)
    __launch_bounds__(kRasterThreads, 2) rasterize_cluster(
        const long long* __restrict__ word, const int* __restrict__ aux,
        const int* __restrict__ start, const int* __restrict__ origin,
        const float* __restrict__ lane, uint8_t* __restrict__ occupancy,
        uint8_t* __restrict__ semantic, int G, int window, int rows,
        int cols, float half, float rq, float half_h, float half_w,
        float inv_res) {
  extern __shared__ unsigned long long best[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int n_map = rows * cols;
  for (int k = threadIdx.x; k < n_map; k += kRasterThreads) best[k] = 0ull;
  __syncthreads();

  const RasterLane L = raster_lane(start, origin, lane, b);
  const int band = (window + kRasterCluster - 1) / kRasterCluster;
  const int i0 = min(window, rank * band);
  const int n_cells = (min(window, i0 + band) - i0) * window;
  // the window's corner; its cell (i, j) lies i * G + j further on
  const long long* __restrict__ win_word =
      word + ((size_t)b * G + L.sr) * G + L.sc;
  const int* __restrict__ win_aux = aux + ((size_t)b * G + L.sr) * G + L.sc;
  // every lane of a warp runs the same iterations (the shuffles below)
  const int lane_id = threadIdx.x & 31;
  for (int base = threadIdx.x - lane_id; base < n_cells;
       base += kRasterUnroll * kRasterThreads) {
    unsigned off[kRasterUnroll];
    int key[kRasterUnroll], a[kRasterUnroll];
    bool ok[kRasterUnroll];
    // the height keys (the words' high halves), then the payloads of the
    // points in the height window, each group all in flight
#pragma unroll
    for (int u = 0; u < kRasterUnroll; ++u) {
      const int t = base + lane_id + u * kRasterThreads;
      const int di = t / window;
      off[u] = (unsigned)(i0 + di) * G + (unsigned)(t - di * window);
      key[u] = t < n_cells
                   ? reinterpret_cast<const int*>(win_word + off[u])[1]
                   : INT_MIN;
    }
#pragma unroll
    for (int u = 0; u < kRasterUnroll; ++u) {
      ok[u] = in_height(L, key[u]);
      a[u] = ok[u] ? win_aux[off[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kRasterUnroll; ++u) {
      const int t = base + lane_id + u * kRasterThreads;
      const int i = i0 + t / window;
      const int j = t - (t / window) * window;
      unsigned long long cand = 0ull;
      const int m = ok[u] ? raster_place(L, i, j, i * window + j, key[u],
                                         a[u], rows, cols, half, rq, half_h,
                                         half_w, inv_res, &cand)
                          : -1;
      // neighbouring window cells often share a map cell: one whose left
      // or right lane holds the same map cell and a higher candidate
      // cannot be the cell's maximum and skips its shared atomic
      const int left_m = __shfl_up_sync(kFullMask, m, 1);
      const unsigned long long left = __shfl_up_sync(kFullMask, cand, 1);
      const int right_m = __shfl_down_sync(kFullMask, m, 1);
      const unsigned long long right = __shfl_down_sync(kFullMask, cand, 1);
      if (m >= 0 && !(left_m == m && left > cand) &&
          !(right_m == m && right > cand)) {
        atomicMax(best + m, cand);
      }
    }
  }
  cluster.sync();

  // this block's share of the map: the max over the cluster's copies
  const int share = (n_map + kRasterCluster - 1) / kRasterCluster;
  const int m0 = min(n_map, rank * share);
  const int m1 = min(n_map, m0 + share);
  const size_t out = (size_t)b * n_map;
  for (int k = m0 + threadIdx.x; k < m1; k += kRasterThreads) {
    unsigned long long v = 0ull;
#pragma unroll
    for (int q = 0; q < kRasterCluster; ++q) {
      const unsigned long long peer = cluster.map_shared_rank(best, q)[k];
      v = peer > v ? peer : v;
    }
    write_map_cell(v, out + k, occupancy, semantic);
  }
  cluster.sync();
}

// One known-map point: its inputs, and its grid cell, key and payload.
struct RawPoint {
  float x, y, z;
  uint8_t label;
};

struct KnownPoint {
  bool inside;
  int r, c;        // its cell in the row, when inside
  long long cell;  // the same in the whole grid
  int key;
  int aux;
};

__device__ __forceinline__ RawPoint raw_point(const float* __restrict__ xyz,
                                              const uint8_t* __restrict__ sem,
                                              size_t p) {
  return RawPoint{xyz[3 * p], xyz[3 * p + 1], xyz[3 * p + 2], sem[p]};
}

// Point q of cloud l, loaded into row rows[l] whose cell (0, 0) is the
// absolute half-resolution cell origin[l].
__device__ __forceinline__ KnownPoint known_point_of(
    const RawPoint& q, const int* __restrict__ rows,
    const int* __restrict__ origin, int l, int G, float half,
    float inv_half) {
  const int r_abs = __float2int_rn(__fmul_rn(q.z, inv_half));
  const int c_abs = __float2int_rn(__fmul_rn(q.x, inv_half));
  KnownPoint out;
  out.r = r_abs - origin[2 * l];
  out.c = c_abs - origin[2 * l + 1];
  out.inside = out.r >= 0 && out.r < G && out.c >= 0 && out.c < G;
  out.cell = ((long long)rows[l] * G + out.r) * G + out.c;
  out.key = sortable_from_float(q.y);
  out.aux = (quantize(q.x, c_abs, half, inv_half) << 18) |
            (quantize(q.z, r_abs, half, inv_half) << 4) | (q.label & 0xF);
  return out;
}

// ---------------------------------------------------------------------------
// K3, tiled design: each chunk of the cloud sorted by tile into its own
// bins, then one block per tile settles it in shared memory and writes it
// whole.
// ---------------------------------------------------------------------------

// How a load of L clouds of N points into G x G rows is cut: tiles of
// 64 x 64 cells, chunks of 2048 points, and the scratch buffer's parts:
// the bins (per lane and chunk, 2048 records: the chunk's points on the
// grid sorted by tile), then per (lane, tile, chunk) the first record of
// the tile's run in the chunk and the run's length.
struct KnownLayout {
  int tiles_side, tiles, chunks;
  size_t starts_at, lengths_at, bytes;
};

KnownLayout known_layout(int L, int N, int G) {
  KnownLayout k;
  k.tiles_side = (G + kKnownTile - 1) / kKnownTile;
  k.tiles = k.tiles_side * k.tiles_side;
  k.chunks = std::max(1, (N + kKnownChunk - 1) / kKnownChunk);
  const size_t runs = (size_t)L * k.tiles * k.chunks;
  k.starts_at = (size_t)L * k.chunks * kKnownChunk * sizeof(int4);
  k.lengths_at = k.starts_at + runs * sizeof(int);
  k.bytes = k.lengths_at + runs * sizeof(int);
  return k;
}

// Dynamic shared memory of the scatter pass (a chunk's records staged in
// tile order, two per-tile counters) and of the tile pass (the tile's
// words and payloads, and three per-chunk arrays: its run's start, length
// and the exclusive scan of the lengths).
size_t known_scatter_smem(int tiles) {
  return (size_t)kKnownChunk * sizeof(int4) + (size_t)2 * tiles * sizeof(int);
}

size_t known_tile_smem(int chunks) {
  return kKnownTileSmem + (size_t)3 * chunks * sizeof(int);
}

// Exclusive scan of in[0..n) into out[0..n) by a block of kThreads
// threads, each taking a run of consecutive entries; returns the total to
// every thread, with out[] visible to the whole block. warp_sums holds
// kThreads / 32 + 1 ints of shared memory.
template <int kThreads>
__device__ int block_exclusive_scan(const int* in, int* out, int n,
                                    int* warp_sums) {
  constexpr int kWarps = kThreads / 32;
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(n, (int)threadIdx.x * per);
  const int i1 = min(n, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += in[i];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFullMask, wi, d);
      if (lane >= d) wi += v;
    }
    if (lane < kWarps) warp_sums[lane] = wi - w;
    if (lane == kWarps - 1) warp_sums[kWarps] = wi;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = i0; i < i1; ++i) {
    out[i] = run;
    run += in[i];
  }
  const int total = warp_sums[kWarps];
  __syncthreads();
  return total;
}

// Launch 1, grid (chunks, L): chunk blockIdx.x of cloud l, 8 points per
// thread (index chunk * 2048 + u * 256 + tid) with all their loads in
// flight. Its points on the grid are sorted by tile in shared memory (a
// counting sort) and written, in tile order, to the chunk's own 2048
// records of the bins: one contiguous store. Each tile's run (its first
// record in the chunk, its length) goes to the run tables at
// [l][tile][chunk]. Off-grid points add to dropped[rows[l]]. A record is
// (low word, key, payload, cell in the tile).
__global__ void __launch_bounds__(kKnownThreads, 4) known_bin_scatter(
    int4* __restrict__ bins, int* __restrict__ run_start,
    int* __restrict__ run_length, int* __restrict__ dropped,
    const int* __restrict__ rows, const int* __restrict__ origin,
    const float* __restrict__ xyz, const uint8_t* __restrict__ sem,
    const int* __restrict__ counts, int N, int G, int tiles_side,
    float half, float inv_half) {
  extern __shared__ int4 stage[];
  __shared__ int warp_sums[kKnownThreads / 32 + 1];
  const int l = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tiles = tiles_side * tiles_side;
  int* tile_count = reinterpret_cast<int*>(stage + kKnownChunk);
  int* tile_first = tile_count + tiles;
  for (int t = threadIdx.x; t < tiles; t += kKnownThreads) tile_count[t] = 0;
  const int count = min(counts[l], N);
  int tile[kKnownChunkPerThread], rank[kKnownChunkPerThread];
  int4 rec[kKnownChunkPerThread];
  int lost = 0;
  const int first = chunk * kKnownChunk;
  if (first < count) {
    // a point past the count loads point 0, a real one, and is dropped
    RawPoint q[kKnownChunkPerThread];
#pragma unroll
    for (int u = 0; u < kKnownChunkPerThread; ++u) {
      const int i = first + u * kKnownThreads + threadIdx.x;
      q[u] = raw_point(xyz, sem, (size_t)l * N + (i < count ? i : 0));
    }
#pragma unroll
    for (int u = 0; u < kKnownChunkPerThread; ++u) {
      const int i = first + u * kKnownThreads + threadIdx.x;
      const KnownPoint kp =
          known_point_of(q[u], rows, origin, l, G, half, inv_half);
      const bool real = i < count;
      tile[u] = real && kp.inside ? (kp.r >> kKnownTileShift) * tiles_side +
                                        (kp.c >> kKnownTileShift)
                                  : -1;
      rec[u] = make_int4((int)(0xFFFFFFFEu - (unsigned)i), kp.key, kp.aux,
                         ((kp.r & (kKnownTile - 1)) << kKnownTileShift) |
                             (kp.c & (kKnownTile - 1)));
      lost += real && !kp.inside;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kKnownChunkPerThread; ++u) tile[u] = -1;
  }
  lost = __reduce_add_sync(kFullMask, lost);
  if ((threadIdx.x & 31) == 0 && lost != 0) {
    atomicAdd(dropped + rows[l], lost);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kKnownChunkPerThread; ++u) {
    rank[u] = tile[u] >= 0 ? atomicAdd(tile_count + tile[u], 1) : 0;
  }
  __syncthreads();
  const int n = block_exclusive_scan<kKnownThreads>(tile_count, tile_first,
                                                    tiles, warp_sums);
#pragma unroll
  for (int u = 0; u < kKnownChunkPerThread; ++u) {
    if (tile[u] >= 0) stage[tile_first[tile[u]] + rank[u]] = rec[u];
  }
  __syncthreads();
  int4* out = bins + ((size_t)l * gridDim.x + chunk) * kKnownChunk;
  for (int k = threadIdx.x; k < n; k += kKnownThreads) out[k] = stage[k];
  const size_t runs = ((size_t)l * tiles) * gridDim.x + chunk;
  for (int t = threadIdx.x; t < tiles; t += kKnownThreads) {
    run_start[runs + (size_t)t * gridDim.x] = tile_first[t];
    run_length[runs + (size_t)t * gridDim.x] = tile_count[t];
  }
}

__device__ __forceinline__ long long record_word(const int4& rec) {
  return make_word(rec.y, (unsigned)rec.x);
}

// Records k0 + u * 512 + tid (u < 4) of a tile, all loaded at once: the
// tile's runs in every chunk, flattened; each record's chunk is found by
// a binary search of the runs' scanned lengths (prefix, chunks + 1
// entries). Past the tile's n records, cell -1.
__device__ __forceinline__ void gather_tile_records(
    const int4* __restrict__ lane_bins, const int* start, const int* prefix,
    int chunks, int n, int k0, int4 (&r)[kKnownRecordUnroll]) {
#pragma unroll
  for (int u = 0; u < kKnownRecordUnroll; ++u) {
    const int k = k0 + u * kKnownTileThreads + threadIdx.x;
    r[u] = make_int4(0, 0, 0, -1);
    if (k < n) {
      // the last chunk whose run begins at or before k
      int lo = 0, hi = chunks - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (prefix[mid] <= k) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      r[u] = lane_bins[(size_t)lo * kKnownChunk + start[lo] +
                       (k - prefix[lo])];
    }
  }
}

// Launch 2, grid (tiles, L): tile t of row rows[l], settled in shared
// memory from its records and written whole. Every cell of the row is
// written, so the row needs no clear beforehand. `aligned`: the rows'
// base addresses are 16-byte aligned and G % 4 == 0, so a full tile's
// rows go out as 16-byte stores.
__global__ void __launch_bounds__(kKnownTileThreads) known_tile_load(
    long long* __restrict__ word, int* __restrict__ aux,
    const int4* __restrict__ bins, const int* __restrict__ run_start,
    const int* __restrict__ run_length, const int* __restrict__ rows,
    int G, int tiles_side, int chunks, bool aligned) {
  extern __shared__ long long tile_word[];
  __shared__ int warp_sums[kKnownTileThreads / 32 + 1];
  int* tile_aux = reinterpret_cast<int*>(tile_word + kKnownTileCells);
  int* start = tile_aux + kKnownTileCells;
  int* length = start + chunks;
  int* prefix = length + chunks;
  const int l = blockIdx.y;
  const int t = blockIdx.x;
  const int tiles = tiles_side * tiles_side;
  const size_t runs = ((size_t)l * tiles + t) * chunks;
  for (int c = threadIdx.x; c < chunks; c += kKnownTileThreads) {
    start[c] = run_start[runs + c];
    length[c] = run_length[runs + c];
  }
  for (int k = threadIdx.x; k < kKnownTileCells; k += kKnownTileThreads) {
    tile_word[k] = kEmptyWord;
    tile_aux[k] = 0;
  }
  __syncthreads();
  const int n = block_exclusive_scan<kKnownTileThreads>(length, prefix,
                                                        chunks, warp_sums);
  const int4* lane_bins = bins + (size_t)l * chunks * kKnownChunk;
  constexpr int kStep = kKnownTileThreads * kKnownRecordUnroll;
  // the max of each cell's words. A thread's first records stay in
  // registers for the second sweep; a tile may hold any number more.
  int4 kept[kKnownRecordUnroll], r[kKnownRecordUnroll];
  gather_tile_records(lane_bins, start, prefix, chunks, n, 0, kept);
#pragma unroll
  for (int u = 0; u < kKnownRecordUnroll; ++u) {
    if (kept[u].w >= 0) atomicMax(tile_word + kept[u].w, record_word(kept[u]));
  }
  for (int k0 = kStep; k0 < n; k0 += kStep) {
    gather_tile_records(lane_bins, start, prefix, chunks, n, k0, r);
#pragma unroll
    for (int u = 0; u < kKnownRecordUnroll; ++u) {
      if (r[u].w >= 0) atomicMax(tile_word + r[u].w, record_word(r[u]));
    }
  }
  __syncthreads();
  // the record that holds its cell's max writes its payload (words are
  // distinct within a cell: their low words hold the point index)
#pragma unroll
  for (int u = 0; u < kKnownRecordUnroll; ++u) {
    if (kept[u].w >= 0 && tile_word[kept[u].w] == record_word(kept[u])) {
      tile_aux[kept[u].w] = kept[u].z;
    }
  }
  for (int k0 = kStep; k0 < n; k0 += kStep) {
    gather_tile_records(lane_bins, start, prefix, chunks, n, k0, r);
#pragma unroll
    for (int u = 0; u < kKnownRecordUnroll; ++u) {
      if (r[u].w >= 0 && tile_word[r[u].w] == record_word(r[u])) {
        tile_aux[r[u].w] = r[u].z;
      }
    }
  }
  __syncthreads();
  // the tile out: a winner's word becomes key << 32 | 0xFFFFFFFF, and an
  // empty cell's word already is EMPTY_KEY << 32 | 0xFFFFFFFF
  const int r0 = (t / tiles_side) * kKnownTile;
  const int c0 = (t % tiles_side) * kKnownTile;
  const size_t at = ((size_t)rows[l] * G + r0) * G + c0;
  long long* out_word = word + at;
  int* out_aux = aux + at;
  const int n_rows = min(kKnownTile, G - r0);
  const int n_cols = min(kKnownTile, G - c0);
  if (aligned && n_rows == kKnownTile && n_cols == kKnownTile) {
    // two words per 16-byte store: the int4's .x and .z are their low
    // words
    for (int k = threadIdx.x; k < kKnownTileCells / 2;
         k += kKnownTileThreads) {
      const int rr = k / (kKnownTile / 2);
      const int cc = (k % (kKnownTile / 2)) * 2;
      int4 v = *reinterpret_cast<const int4*>(tile_word + rr * kKnownTile +
                                              cc);
      v.x = (int)kIncumbentLow;
      v.z = (int)kIncumbentLow;
      __stcs(reinterpret_cast<int4*>(out_word + (size_t)rr * G + cc), v);
    }
    for (int k = threadIdx.x; k < kKnownTileCells / 4;
         k += kKnownTileThreads) {
      const int rr = k / (kKnownTile / 4);
      const int cc = (k % (kKnownTile / 4)) * 4;
      __stcs(reinterpret_cast<int4*>(out_aux + (size_t)rr * G + cc),
             *reinterpret_cast<const int4*>(tile_aux + rr * kKnownTile + cc));
    }
  } else {
    for (int k = threadIdx.x; k < kKnownTileCells; k += kKnownTileThreads) {
      const int rr = k >> kKnownTileShift;
      const int cc = k & (kKnownTile - 1);
      if (rr < n_rows && cc < n_cols) {
        out_word[(size_t)rr * G + cc] =
            tile_word[k] | (long long)kIncumbentLow;
        out_aux[(size_t)rr * G + cc] = tile_aux[k];
      }
    }
  }
}

dim3 accumulate_tiles(int B, int H, int W) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// How many 8-block clusters of the cluster rasterize the card holds at
// once, for a rows x cols map.
extern "C" int mapper_rasterize_resident_clusters(int rows, int cols,
                                                  int* clusters) {
  const size_t smem = (size_t)rows * cols * sizeof(unsigned long long);
  const cudaError_t err =
      allow_smem((const void*)rasterize_cluster, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kRasterCluster, 1, 1);
  config.blockDim = dim3(kRasterThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (const void*)rasterize_cluster, &config);
}

// Bytes of scratch mapper_accumulate needs for B frames of H x W: each
// warp's candidate ballots.
extern "C" long long mapper_accumulate_scratch_bytes(int B, int H, int W) {
  const dim3 t = accumulate_tiles(B, H, W);
  return (long long)t.x * t.y * t.z * kTileWarps * sizeof(uint4);
}

extern "C" int mapper_accumulate(
    long long* word, int* aux, int* dropped, const float* depth,
    const uint8_t* sem, const float* lane, const int* origin,
    const float* rays_x, const float* rays_y, void* scratch, int B, int H,
    int W, int G, float dmin, float dmax, float dscale, float half,
    float inv_half, cudaStream_t stream) {
  // a lane's cell id r * G + c must fit the warp match's 32 bits
  if ((long long)G * G > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const dim3 grid = accumulate_tiles(B, H, W);
  if ((long long)grid.x * grid.y * grid.z == 0) return 0;
  uint4* ballots = static_cast<uint4*>(scratch);
  accumulate_tile_max<<<grid, kTileThreads, 0, stream>>>(
      word, dropped, ballots, depth, sem, lane, origin, rays_x, rays_y, H, W,
      G, dmin, dmax, dscale, half, inv_half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  accumulate_tile_commit<<<grid, kTileThreads, 0, stream>>>(
      word, aux, ballots, depth, sem, lane, origin, rays_x, rays_y, H, W, G,
      dmin, dmax, dscale, half, inv_half);
  return (int)cudaGetLastError();
}

extern "C" int mapper_rasterize(
    const long long* word, const int* aux, const int* start,
    const int* origin, const float* lane, uint8_t* occupancy,
    uint8_t* semantic, int B, int G, int window, int rows, int cols,
    float half, float rq, float half_h, float half_w, float inv_res,
    cudaStream_t stream) {
  // a window cell's offset i * G + j must fit 32 bits
  if ((long long)G * G > 0xFFFFFFFFll) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rows * cols * sizeof(unsigned long long);
  cudaError_t err = allow_smem((const void*)rasterize_cluster, smem);
  if (err != cudaSuccess) return (int)err;
  rasterize_cluster<<<dim3(kRasterCluster, B), kRasterThreads, smem,
                      stream>>>(word, aux, start, origin, lane, occupancy,
                                semantic, G, window, rows, cols, half, rq,
                                half_h, half_w, inv_res);
  return (int)cudaGetLastError();
}

// Bytes of scratch mapper_known_load needs for L clouds of N points into
// G x G rows: counts, offsets and bins (16 bytes per point).
extern "C" long long mapper_known_load_scratch_bytes(int L, int N, int G) {
  return (long long)known_layout(L, N, G).bytes;
}

// Rows rows[0..L) (distinct) are overwritten: cleared, then loaded with
// cloud l's first counts[l] points.
extern "C" int mapper_known_load(
    long long* word, int* aux, int* dropped, const int* rows,
    const int* origin, const float* xyz, const uint8_t* sem,
    const int* counts, void* scratch, int L, int N, int G, float half,
    float inv_half, cudaStream_t stream) {
  if (L == 0) return 0;
  const KnownLayout k = known_layout(L, N, G);
  char* base = static_cast<char*>(scratch);
  int4* bins = reinterpret_cast<int4*>(base);
  int* run_start = reinterpret_cast<int*>(base + k.starts_at);
  int* run_length = reinterpret_cast<int*>(base + k.lengths_at);
  const size_t scatter_smem = known_scatter_smem(k.tiles);
  const size_t tile_smem = known_tile_smem(k.chunks);
  cudaError_t err = allow_smem((const void*)known_bin_scatter, scatter_smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem((const void*)known_tile_load, tile_smem);
  if (err != cudaSuccess) return (int)err;
  known_bin_scatter<<<dim3(k.chunks, L), kKnownThreads, scatter_smem,
                      stream>>>(bins, run_start, run_length, dropped, rows,
                                origin, xyz, sem, counts, N, G,
                                k.tiles_side, half, inv_half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool aligned = G % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(word) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(aux) % 16 == 0;
  known_tile_load<<<dim3(k.tiles, L), kKnownTileThreads, tile_smem,
                    stream>>>(word, aux, bins, run_start, run_length, rows,
                              G, k.tiles_side, k.chunks, aligned);
  return (int)cudaGetLastError();
}

extern "C" const char* mapper_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
