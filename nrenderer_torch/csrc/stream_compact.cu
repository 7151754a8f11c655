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
// cannot scatter; none of that is the contract.  Here both kernels work on
// tiles of TILE = 4096 lanes: 256 threads, each holding four groups of 4
// consecutive lanes 1024 lanes apart, which it reads as four 128-bit words
// per channel; a warp's word of one group is 512 contiguous bytes.
//
// The pack is ONE kernel launch, after a cudaMemsetAsync that clears its
// look-back scratch: count, scan, scatter and the clear of the slots past
// the count in one grid, reading the mask once.  It is a single-pass scan
// with decoupled look-back (Merrill and Garland, 2016).  A block takes its
// tile from an atomic counter, so a tile only ever waits on tiles already
// running.  It reads the mask channel, ranks its live lanes (__popc of each
// group's 4-bit live mask; the four groups' counts scanned together in
// 16-bit fields of two words by a warp scan and the 8 warp totals in
// shared memory) and publishes its aggregate as a 64-bit {flag, value}
// status word (release/acquire, in L2); one warp sums the predecessors'
// words 32 at a time back to the first inclusive prefix, and the tile
// publishes its own.  The tile writes its exclusive prefix to tile_off,
// the last tile writes the count.  Then, channel by channel (the mask
// channel's words are the ones already read), each thread loads only the
// 128-bit words that hold a live lane (a tile without a live lane reads no
// channel), compacts the live words into shared memory in rank order, and
// the block writes them to packed[c][off, off + live), clipped at cap, as
// one coalesced run of 128-bit stores; the next channel's loads are in
// flight while the current one is written.  The grid's last blocks take
// indices past the tiles from the same counter, wait for the last tile's
// inclusive prefix, and zero [min(count, cap), cap) of every channel with
// 128-bit stores.
//
// The unpack is one launch: each block ranks its tile's lanes from the
// mask as the pack did, reads its base slot from the pack's tile_off,
// copies each channel's run of packed words [base, base + live) (clipped
// at min(count, cap) and at the channel's length) into shared memory with
// coalesced 128-bit loads (the next channel's run in flight while this one
// is written), and each thread writes its 16 output words (fill, the
// staged word, or 0) as four 128-bit stores.  A tile without a slot is a
// pure fill store.
//
// Bound: bytes.  The pack reads the mask once, each other channel only in
// the 128-bit words that hold a live lane, writes the kept words once and
// zeroes the slots past the count; the unpack reads the mask and the live
// slots and writes C x n words.  The channel tables are copied to shared
// memory, so no kernel indexes its parameters with a run-time channel (a
// local-memory copy).  Plain C interface, loaded with ctypes: each
// launcher returns the CUDA error of its calls.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_CHANNELS = 16;
constexpr int TILE = 4096;   // lanes per block of the pack and the unpack
constexpr int THREADS = 256;
// 64 registers a thread, 4 x 33 KB of shared memory: 5 or 6 blocks an SM
// cap the registers at 48 or 40 and spill
constexpr int BLOCKS_PER_SM = 4;
constexpr int GROUPS = 4;    // 4-lane groups a thread holds, TILE / 4 apart
constexpr int LANES = 4 * GROUPS;
constexpr int STRIDE = 4 * THREADS;  // lanes from one group to the next
constexpr int WARPS = THREADS / 32;
constexpr int BUF = TILE + 4;  // a staged run and its 16-byte alignment
// 16-byte words of a staged buffer a thread moves (BUF / 4 / THREADS, up)
constexpr int RUN_VECS = (BUF / 4 + THREADS - 1) / THREADS;
constexpr int MAX_CLEAR_BLOCKS = 264;    // two per SM of an H100
constexpr int CLEAR_WORDS = 64 * 1024;   // words a clearing block aims at
constexpr unsigned FULL = 0xffffffffu;
// look-back status: flag in the high word, the value in the low word
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;

static_assert(TILE == THREADS * LANES, "a tile is 16 lanes a thread");

struct Chans {
  const unsigned* p[MAX_CHANNELS];
};

struct LenFill {
  int len[MAX_CHANNELS];        // words each packed channel holds
  unsigned fill[MAX_CHANNELS];  // the word of a lane without a slot
};

// a[i] with every index a compile-time one (no local copy of a parameter
// array indexed at run time)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[MAX_CHANNELS], int i) {
  T v = a[0];
#pragma unroll
  for (int c = 1; c < MAX_CHANNELS; ++c)
    if (i == c) v = a[c];
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// This thread's lanes of the tile at lane t0: group k is lanes
// [t0 + k * STRIDE + 4 * threadIdx.x, + 4), so a warp's group is 512
// contiguous bytes.  The words of the groups whose bit is set in `which`
// go to w[4k .. 4k + 4) (the others are left as they are); lanes >= n read
// 0.  `vec`: p is 16-byte aligned, so whole groups load as uint4.
__device__ __forceinline__ void load16(const unsigned* __restrict__ p,
                                       int t0, int n, bool vec,
                                       unsigned which, unsigned (&w)[LANES]) {
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    if (!((which >> k) & 1u)) continue;
    const int i = t0 + k * STRIDE + 4 * threadIdx.x;
    if (vec && i + 4 <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[4 * k + j] = i + j < n ? p[i + j] : 0u;
    }
  }
}

// The live mask of 16 mask words (bit 4k + j: lane j of group k), and the
// groups that hold a live lane.
__device__ __forceinline__ unsigned live_bits(const unsigned (&m)[LANES],
                                              unsigned* groups) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < LANES; ++j)
    bits |= (__uint_as_float(m[j]) > 0.0f ? 1u : 0u) << j;
  unsigned g = 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k)
    if ((bits >> (4 * k)) & 15u) g |= 1u << k;
  *groups = g;
  return bits;
}

// The rank of each group's first lane among the tile's live lanes in lane
// order (group k of every thread before group k + 1), and the tile's live
// count.  The four groups' counts scan together, 16 bits each, in two
// words: a warp scan, then the 8 warp totals in shared memory.  Every
// thread of the block calls it.
__device__ __forceinline__ int block_rank(unsigned bits, int2* warp_sum,
                                          int (&rank)[GROUPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c[GROUPS];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) c[k] = __popc((bits >> (4 * k)) & 15u);
  const int x = c[0] | (c[1] << 16), y = c[2] | (c[3] << 16);
  int ix = x, iy = y;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ux = __shfl_up_sync(FULL, ix, o);
    const int uy = __shfl_up_sync(FULL, iy, o);
    if (lane >= o) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == 31) warp_sum[warp] = make_int2(ix, iy);
  __syncthreads();
  int bx = 0, by = 0, tx = 0, ty = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int2 s = warp_sum[w];
    if (w < warp) {
      bx += s.x;
      by += s.y;
    }
    tx += s.x;
    ty += s.y;
  }
  const int ex = bx + ix - x, ey = by + iy - y;  // exclusive, per field
  const int t0 = tx & 0xffff, t1 = tx >> 16, t2 = ty & 0xffff;
  rank[0] = ex & 0xffff;
  rank[1] = t0 + (ex >> 16);
  rank[2] = t0 + t1 + (ey & 0xffff);
  rank[3] = t0 + t1 + t2 + (ey >> 16);
  return t0 + t1 + t2 + (ty >> 16);
}

// The live lanes before `tile` (one warp): publish the aggregate, sum the
// predecessors' status words 32 at a time back to the first inclusive
// prefix, publish this tile's inclusive prefix.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         int tile, int agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_release(status, FLAG_PREFIX | (unsigned)agg);
    return 0;
  }
  if (lane == 0) store_release(status + tile, FLAG_AGGREGATE | (unsigned)agg);
  int excl = 0;
  for (int j0 = tile - 1;; j0 -= 32) {
    const int j = j0 - lane;
    unsigned long long s;
    for (;;) {
      s = j >= 0 ? load_acquire(status + j) : FLAG_PREFIX;
      if (!__any_sync(FULL, (s >> 32) == 0)) break;
      __nanosleep(32);
    }
    // lanes up to and including the nearest inclusive prefix count
    const unsigned pre = __ballot_sync(FULL, (s >> 32) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)s : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    excl += v;
    if (pre) break;
  }
  if (lane == 0)
    store_release(status + tile, FLAG_PREFIX | (unsigned)(excl + agg));
  return excl;
}

// The live words of w (bits) whose rank is below `kept` to sb[sh + rank].
__device__ __forceinline__ void stage_live(const unsigned (&w)[LANES],
                                           unsigned bits,
                                           const int (&rank)[GROUPS],
                                           int kept, unsigned* sb, int sh) {
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    int r = rank[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((bits >> (4 * k + j)) & 1u) {
        if (r < kept) sb[sh + r] = w[4 * k + j];
        ++r;
      }
    }
  }
}

// base[lo, hi) = sb[lo, hi) by the block; base and sb are 16-byte aligned,
// whole 16-byte words move as uint4.
__device__ __forceinline__ void store_run(unsigned* __restrict__ base,
                                          const unsigned* sb, int lo,
                                          int hi) {
  const int n_vec = (hi + 3) >> 2;
  for (int v = threadIdx.x; v < n_vec; v += THREADS) {
    const int w0 = 4 * v;
    if (w0 >= lo && w0 + 4 <= hi) {
      reinterpret_cast<uint4*>(base)[v] =
          reinterpret_cast<const uint4*>(sb)[v];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (w0 + j >= lo && w0 + j < hi) base[w0 + j] = sb[w0 + j];
    }
  }
}

// A run of packed words to stage: src[lo, hi) with src 16-byte aligned
// (lo < 4: the run's own alignment).
struct Run {
  const unsigned* src;
  int lo, hi;
};

__device__ __forceinline__ Run run_of(const unsigned* p, int base, int len) {
  const int sh = (int)((reinterpret_cast<uintptr_t>(p + base) >> 2) & 3u);
  return {p + base - sh, sh, sh + len};
}

// This thread's 16-byte words of a run into q (words outside the run read
// 0), then, after the previous use of the buffer, into shared memory.
__device__ __forceinline__ void run_load(const Run& r, uint4 (&q)[RUN_VECS]) {
#pragma unroll
  for (int k = 0; k < RUN_VECS; ++k) {
    const int w0 = 4 * (threadIdx.x + k * THREADS);
    if (w0 >= r.hi) continue;
    if (w0 >= r.lo && w0 + 4 <= r.hi) {
      q[k] = *reinterpret_cast<const uint4*>(r.src + w0);
    } else {
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = w0 + j >= r.lo && w0 + j < r.hi ? r.src[w0 + j] : 0u;
      q[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void run_stage(const Run& r,
                                          const uint4 (&q)[RUN_VECS],
                                          unsigned* sb) {
#pragma unroll
  for (int k = 0; k < RUN_VECS; ++k) {
    const int v = threadIdx.x + k * THREADS;
    if (4 * v < r.hi) reinterpret_cast<uint4*>(sb)[v] = q[k];
  }
}

// p[lo, hi) = 0 by thread gi of gn; the middle as uint4.
__device__ __forceinline__ void zero_words(unsigned* p, int lo, int hi,
                                           int gi, int gn) {
  if (lo >= hi) return;
  const int head = min(
      hi - lo,
      (int)(((16u - (reinterpret_cast<uintptr_t>(p + lo) & 15u)) & 15u) >> 2));
  const int a = lo + head;
  const int n_vec = (hi - a) >> 2;
  const int tail = a + 4 * n_vec;
  if (gi < head) p[lo + gi] = 0u;
  uint4* q = reinterpret_cast<uint4*>(p + a);
  for (int v = gi; v < n_vec; v += gn) q[v] = make_uint4(0u, 0u, 0u, 0u);
  if (gi < hi - tail) p[tail + gi] = 0u;
}

// status: n_tiles look-back words, then the block counter; all zero at
// launch.  Blocks past the n_tiles tiles clear the slots past the count.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
stream_pack_kernel(const Chans in, const int n_ch, const int n,
                   const int mask_from, const int cap, const int n_tiles,
                   const bool vec, unsigned long long* __restrict__ status,
                   int* __restrict__ tile_off, int* __restrict__ count,
                   unsigned* __restrict__ packed) {
  __shared__ __align__(16) unsigned buf[2][BUF];
  __shared__ const unsigned* s_in[MAX_CHANNELS];
  __shared__ int s_row[MAX_CHANNELS];
  __shared__ int2 s_warp[WARPS];
  __shared__ int s_tile, s_off;
  const int t = threadIdx.x;
  if (t == 0)
    s_tile = (int)atomicAdd(reinterpret_cast<unsigned*>(status + n_tiles), 1u);
  if (t < n_ch) {
    // the mask channel first, the others in order
    const int c = t == 0 ? mask_from : (t <= mask_from ? t - 1 : t);
    s_in[t] = pick(in.p, c);
    s_row[t] = c;
  }
  __syncthreads();
  const int tile = s_tile;

  if (tile >= n_tiles) {
    if (t == 0) {
      int total = 0;
      if (n_tiles > 0) {
        unsigned long long s;
        while (((s = load_acquire(status + n_tiles - 1)) >> 32) != 2)
          __nanosleep(128);
        total = (int)(unsigned)s;
      } else if (tile == 0) {
        *count = 0;
      }
      s_off = total;
    }
    __syncthreads();
    const int lo = min(s_off, cap);
    const int gi = (tile - n_tiles) * THREADS + t;
    const int gn = ((int)gridDim.x - n_tiles) * THREADS;
    for (int c = 0; c < n_ch; ++c)
      zero_words(packed + (size_t)c * cap, lo, cap, gi, gn);
    return;
  }

  const int t0 = tile * TILE;
  unsigned cur[LANES];
  load16(s_in[0], t0, n, vec, 0xfu, cur);
  unsigned groups;
  const unsigned bits = live_bits(cur, &groups);
  int rank[GROUPS];
  const int agg = block_rank(bits, s_warp, rank);
  if (t < 32) {
    const int excl = look_back(status, tile, agg);
    if (t == 0) {
      tile_off[tile] = excl;
      if (tile == n_tiles - 1) *count = excl + agg;
      s_off = excl;
    }
  }
  __syncthreads();
  const int off = s_off;
  const int kept = max(0, min(agg, cap - off));  // live lanes with a slot
  if (kept == 0) return;

  for (int i = 0; i < n_ch; ++i) {
    unsigned* row = packed + (size_t)s_row[i] * cap + off;
    const int sh = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3u);
    unsigned* sb = buf[i & 1];
    stage_live(cur, bits, rank, kept, sb, sh);
    __syncthreads();
    // the next channel's loads are in flight while this one is written
    if (i + 1 < n_ch) load16(s_in[i + 1], t0, n, vec, groups, cur);
    store_run(row - sh, sb, sh, sh + kept);
  }
}

// This thread's 16 output words of one channel: fill on a lane without a
// slot, the staged word of its slot, or 0 past the channel's length;
// group k as one 16-byte store where it can.
__device__ __forceinline__ void emit16(unsigned* __restrict__ row, int t0,
                                       int n, unsigned bits,
                                       const int (&rank)[GROUPS], int kept,
                                       const unsigned* sb, int sh,
                                       int staged, unsigned fill) {
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    unsigned w[4];
    int r = rank[k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = fill;
      if ((bits >> (4 * k + j)) & 1u) {
        if (r < kept) w[j] = r < staged ? sb[sh + r] : 0u;
        ++r;
      }
    }
    const int i = t0 + k * STRIDE + 4 * threadIdx.x;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<uint4*>(row + i) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) row[i + j] = w[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
stream_unpack_kernel(const unsigned* __restrict__ mask, const int n,
                     const int n_ch, const bool vec_mask, const Chans packed,
                     const LenFill lf, const int* __restrict__ tile_off,
                     const int* __restrict__ count, const int cap,
                     unsigned* __restrict__ out) {
  __shared__ __align__(16) unsigned buf[2][BUF];
  __shared__ const unsigned* s_p[MAX_CHANNELS];
  __shared__ int s_len[MAX_CHANNELS];
  __shared__ unsigned s_fill[MAX_CHANNELS];
  __shared__ int2 s_warp[WARPS];
  const int t = threadIdx.x, tile = blockIdx.x;
  if (t < n_ch) {
    s_p[t] = pick(packed.p, t);
    s_len[t] = pick(lf.len, t);
    s_fill[t] = pick(lf.fill, t);
  }
  const int t0 = tile * TILE;
  unsigned m[LANES];
  load16(mask, t0, n, vec_mask, 0xfu, m);
  unsigned groups;
  const unsigned bits = live_bits(m, &groups);
  int rank[GROUPS];
  const int agg = block_rank(bits, s_warp, rank);
  const int base = tile_off[tile];
  const int kept = max(0, min(agg, min(*count, cap) - base));
  if (kept == 0) {  // no lane of the tile has a slot: fill only
    for (int c = 0; c < n_ch; ++c)
      emit16(out + (size_t)c * n, t0, n, 0u, rank, 0, nullptr, 0, 0,
             s_fill[c]);
    return;
  }
  const auto staged = [&](int c) {
    return max(0, min(kept, s_len[c] - base));
  };
  uint4 q[RUN_VECS];
  Run cur = run_of(s_p[0], base, staged(0));
  run_load(cur, q);
  run_stage(cur, q, buf[0]);
  __syncthreads();
  for (int c = 0; c < n_ch; ++c) {
    Run nxt{};
    if (c + 1 < n_ch) {
      nxt = run_of(s_p[c + 1], base, staged(c + 1));
      run_load(nxt, q);
    }
    emit16(out + (size_t)c * n, t0, n, bits, rank, kept, buf[c & 1], cur.lo,
           cur.hi - cur.lo, s_fill[c]);
    if (c + 1 < n_ch) run_stage(nxt, q, buf[(c + 1) & 1]);
    __syncthreads();
    cur = nxt;
  }
}

}  // namespace

extern "C" {

// Packs n lanes of `n_ch` channels (host array of device pointers, each n
// words) by channel `mask_from` into `packed` ((n_ch, cap) words).
// `scratch`: ceil(n / TILE) + 1 device words of 64 bits (the look-back
// status and the block counter; cleared here).  Results, device int32:
// tile_off (ceil(n / TILE)), count (1: the number of live lanes, which may
// pass cap).  One memset and one kernel launch.
int nr_stream_pack(const void* const* chans, int n_ch, int n, int mask_from,
                   int cap, void* packed, void* scratch, int* tile_off,
                   int* count, void* stream) {
  if (n_ch < 1 || n_ch > MAX_CHANNELS || mask_from < 0 ||
      mask_from >= n_ch || n < 0 || n > 0x7fffffff - TILE || cap < 1)
    return (int)cudaErrorInvalidValue;
  Chans in{};
  bool vec = true;
  for (int c = 0; c < n_ch; ++c) {
    in.p[c] = static_cast<const unsigned*>(chans[c]);
    vec = vec && (reinterpret_cast<uintptr_t>(chans[c]) & 15u) == 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + TILE - 1) / TILE;
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      status, 0, sizeof(unsigned long long) * (n_tiles + 1), st);
  if (err != cudaSuccess) return (int)err;
  const long long words = (long long)n_ch * cap;
  const int n_clear = (int)std::min<long long>(
      MAX_CLEAR_BLOCKS, (words + CLEAR_WORDS - 1) / CLEAR_WORDS);
  stream_pack_kernel<<<n_tiles + n_clear, THREADS, 0, st>>>(
      in, n_ch, n, mask_from, cap, n_tiles, vec, status, tile_off, count,
      static_cast<unsigned*>(packed));
  return (int)cudaGetLastError();
}

// Unpacks `n_ch` channels (host array of device pointers; channel c holds
// lens[c] <= cap words) to n lanes of `out` ((n_ch, n) words), by the mask
// the pack ran with and its tile offsets and count; fills[c] elsewhere.
// One kernel launch.
int nr_stream_unpack(const void* mask, int n, int n_ch,
                     const void* const* packed, const int* lens,
                     const unsigned* fills, const int* tile_off,
                     const int* count, int cap, void* out, void* stream) {
  if (n_ch < 1 || n_ch > MAX_CHANNELS || n < 0 || n > 0x7fffffff - TILE ||
      cap < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Chans in{};
  LenFill lf{};
  for (int c = 0; c < n_ch; ++c) {
    if (lens[c] < 0 || lens[c] > cap) return (int)cudaErrorInvalidValue;
    in.p[c] = static_cast<const unsigned*>(packed[c]);
    lf.len[c] = lens[c];
    lf.fill[c] = fills[c];
  }
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  const int n_tiles = (n + TILE - 1) / TILE;
  stream_unpack_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const unsigned*>(mask), n, n_ch, vec, in, lf, tile_off,
      count, cap, static_cast<unsigned*>(out));
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
