// Streaming compactor for NVIDIA Hopper (sm_90a): the pack (B3a) and the
// unpack (B3b) of the hybrid mesh route.
//
// Replaces the TPU kernels nrenderer_tpu/ops/stream_compact.py:198
// _pack_kernel (pallas_call :292, built by _build_pack :280, called by
// stream_pack_channels :321) and :383 _unpack_kernel (pallas_call :427,
// built by _build_unpack :417, called by stream_unpack_channels :451).  The
// Python wrappers, the plain torch versions and the launch counters are in
// nrenderer_torch/ops/stream_compact.py.
//
// What it computes.  The pack takes C channels of n 32-bit words and the
// index of the mask channel; the lanes whose mask word, read as a float, is
// > 0 are live.  The live lanes' words go to slots 0, 1, 2, ... of a
// (C, cap) buffer IN LANE ORDER (a dense, stable pack: the rays keep the
// pixel coherence the sweep relies on); a live lane whose slot would be >=
// cap is dropped, and the count reports the true number of live lanes, so
// the caller sees the overflow.  Every slot from min(count, cap) to cap
// reads 0 in every channel (the mask channel's 0 makes such a slot a dead
// ray wherever it is consumed).  The unpack is the inverse for channels
// computed on the packed buffer: out[c][lane] = packed[c][slot(lane)] for a
// live lane whose slot is < min(count, cap) (0 past a channel's given
// length), fill[c] for every other lane.  Words move as raw bits, so int32
// channels (pixel ids, sample indices, winner ids) survive bit for bit.
//
// The TPU kernel packs per (256, 128) tile and column with 8-row claims, a
// VMEM ring and DMA flushes, because a TPU core runs its grid in order and
// cannot scatter; none of that is the contract.  Here the grid runs in
// parallel, so the pack is four launches over tiles of TILE lanes (one
// lane per thread): pack_count_kernel counts each tile's live lanes
// (__ballot_sync / __popc per warp), pack_scan_kernel (one block) turns the
// counts into each tile's exclusive offset and the total, and
// pack_scatter_kernel ranks each live lane inside its tile (the same ballot
// plus a scan of the 32 warp counts) and writes its C words to slot
// offset + rank; pack_clear_kernel zeroes the slots past the count.  The
// unpack recomputes each lane's slot the same way from the pack's tile
// offsets and gathers, so it needs no per-slot index array.
//
// Bound: bytes.  The pack reads the mask twice and each live lane's words
// once and writes the cap buffer once; the unpack reads the mask, the live
// slots, and writes C x n words.  Reads and writes of consecutive lanes are
// coalesced (a live lane's slot follows the previous live lane's), so both
// run at a fraction of the 3.35 TB/s memory rate that falls with the share
// of dead lanes a warp reads.  Plain C interface, loaded with ctypes: each
// launcher returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CHANNELS = 16;
constexpr int TILE = 1024;  // lanes per block of the count, scatter, unpack
constexpr int WARPS = TILE / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int CLEAR_THREADS = 256;

static_assert(WARPS == 32, "block_rank scans the warp counts in one warp");

struct InWords {
  const unsigned* p[MAX_CHANNELS];
};

struct LenFill {
  int len[MAX_CHANNELS];        // words each packed channel holds
  unsigned fill[MAX_CHANNELS];  // the word of a lane without a slot
};

__device__ __forceinline__ bool is_live(const unsigned* mask, int i, int n) {
  return i < n && __uint_as_float(mask[i]) > 0.0f;
}

// The exclusive rank of this thread's lane among the live lanes of its
// block, in lane order.  Every thread of the block must call it.
__device__ __forceinline__ int block_rank(bool live, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sum[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sum[lane] = v;  // inclusive
  }
  __syncthreads();
  return (warp == 0 ? 0 : warp_sum[warp - 1]) + rank;
}

__global__ void __launch_bounds__(TILE)
pack_count_kernel(const unsigned* __restrict__ mask, const int n,
                  int* __restrict__ tile_cnt) {
  __shared__ int warp_sum[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const unsigned ballot = __ballot_sync(0xffffffffu, is_live(mask, i, n));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = warp_sum[threadIdx.x];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) tile_cnt[blockIdx.x] = v;
  }
}

// One block: thread t sums a contiguous run of tile counts, the block scans
// the runs' sums, and each thread writes its run's exclusive offsets.
__global__ void __launch_bounds__(SCAN_THREADS)
pack_scan_kernel(const int* __restrict__ tile_cnt, const int n_tiles,
                 int* __restrict__ tile_off, int* __restrict__ count) {
  __shared__ int part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int per = (n_tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b0 = min(t * per, n_tiles);
  const int b1 = min(b0 + per, n_tiles);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += tile_cnt[b];
  part[t] = s;
  __syncthreads();
  for (int o = 1; o < SCAN_THREADS; o <<= 1) {
    const int v = t >= o ? part[t - o] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = t == 0 ? 0 : part[t - 1];
  for (int b = b0; b < b1; ++b) {
    tile_off[b] = run;
    run += tile_cnt[b];
  }
  if (t == SCAN_THREADS - 1) *count = part[t];
}

__global__ void __launch_bounds__(TILE)
pack_scatter_kernel(const InWords in, const int n_ch, const int n,
                    const int mask_from, const int cap,
                    const int* __restrict__ tile_off,
                    unsigned* __restrict__ packed) {
  __shared__ int warp_sum[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool live = is_live(in.p[mask_from], i, n);
  const int slot = tile_off[blockIdx.x] + block_rank(live, warp_sum);
  if (live && slot < cap) {
    for (int c = 0; c < n_ch; ++c)
      packed[(size_t)c * cap + slot] = in.p[c][i];
  }
}

__global__ void __launch_bounds__(CLEAR_THREADS)
pack_clear_kernel(const int n_ch, const int cap,
                  const int* __restrict__ count,
                  unsigned* __restrict__ packed) {
  const int j = blockIdx.x * CLEAR_THREADS + threadIdx.x;
  if (j >= cap || j < *count) return;
  for (int c = 0; c < n_ch; ++c) packed[(size_t)c * cap + j] = 0u;
}

__global__ void __launch_bounds__(TILE)
unpack_kernel(const unsigned* __restrict__ mask, const int n, const int n_ch,
              const InWords packed, const LenFill lf,
              const int* __restrict__ tile_off,
              const int* __restrict__ count, const int cap,
              unsigned* __restrict__ out) {
  __shared__ int warp_sum[WARPS];
  const int i = blockIdx.x * TILE + threadIdx.x;
  const bool live = is_live(mask, i, n);
  const int slot = tile_off[blockIdx.x] + block_rank(live, warp_sum);
  if (i >= n) return;
  const bool has_slot = live && slot < min(*count, cap);
  for (int c = 0; c < n_ch; ++c) {
    unsigned v = lf.fill[c];
    if (has_slot) v = slot < lf.len[c] ? packed.p[c][slot] : 0u;
    out[(size_t)c * n + i] = v;
  }
}

}  // namespace

extern "C" {

// Packs n lanes of `n_ch` channels (host array of device pointers, each n
// words) by channel `mask_from` into `packed` ((n_ch, cap) words).  Scratch
// and results, device int32: tile_cnt and tile_off (ceil(n / TILE) each),
// count (1: the number of live lanes, which may pass cap).
int nr_stream_pack(const void* const* chans, int n_ch, int n, int mask_from,
                   int cap, void* packed, int* tile_cnt, int* tile_off,
                   int* count, void* stream) {
  if (n_ch < 1 || n_ch > MAX_CHANNELS || mask_from < 0 ||
      mask_from >= n_ch || n < 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  InWords in{};
  for (int c = 0; c < n_ch; ++c)
    in.p[c] = static_cast<const unsigned*>(chans[c]);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + TILE - 1) / TILE;
  if (n_tiles > 0) {
    pack_count_kernel<<<n_tiles, TILE, 0, st>>>(in.p[mask_from], n,
                                                tile_cnt);
  }
  pack_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(tile_cnt, n_tiles, tile_off,
                                               count);
  unsigned* out = static_cast<unsigned*>(packed);
  if (n_tiles > 0) {
    pack_scatter_kernel<<<n_tiles, TILE, 0, st>>>(in, n_ch, n, mask_from,
                                                  cap, tile_off, out);
  }
  pack_clear_kernel<<<(cap + CLEAR_THREADS - 1) / CLEAR_THREADS,
                      CLEAR_THREADS, 0, st>>>(n_ch, cap, count, out);
  return (int)cudaGetLastError();
}

// Unpacks `n_ch` channels (host array of device pointers; channel c holds
// lens[c] <= cap words) to n lanes of `out` ((n_ch, n) words), by the mask
// the pack ran with and its tile offsets and count; fills[c] elsewhere.
int nr_stream_unpack(const void* mask, int n, int n_ch,
                     const void* const* packed, const int* lens,
                     const unsigned* fills, const int* tile_off,
                     const int* count, int cap, void* out, void* stream) {
  if (n_ch < 1 || n_ch > MAX_CHANNELS || n < 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  InWords in{};
  LenFill lf{};
  for (int c = 0; c < n_ch; ++c) {
    if (lens[c] < 0 || lens[c] > cap) return (int)cudaErrorInvalidValue;
    in.p[c] = static_cast<const unsigned*>(packed[c]);
    lf.len[c] = lens[c];
    lf.fill[c] = fills[c];
  }
  const int n_tiles = (n + TILE - 1) / TILE;
  unpack_kernel<<<n_tiles, TILE, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned*>(mask), n, n_ch, in, lf, tile_off, count,
      cap, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

// The layout this library was built with: what = 0 gives the most channels
// one call moves, what = 1 the lanes per tile.
int nr_stream_layout(int what) {
  switch (what) {
    case 0: return MAX_CHANNELS;
    case 1: return TILE;
    default: return -1;
  }
}

}  // extern "C"
