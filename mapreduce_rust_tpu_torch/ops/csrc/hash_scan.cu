// Segmented token-hash scan for Hopper (sm_90a): the port of the Pallas TPU
// kernel mapreduce_rust_tpu/ops/tokenize_pallas.py::hash_scan_pallas, with
// the token-end epilogue that XLA fuses around it on the TPU
// (mapreduce_rust_tpu/ops/tokenize.py::_tokenize) fused in as a second entry.
//
// What it computes. For a byte chunk in[0, n), the inclusive scan at every
// byte of the token-hash monoid (f, m1, a1, m2, a2, c), which acts on a
// hash h as h -> h*m + a:
//   word char ([A-Za-z0-9_] or any byte >= 0x80): (0, MULT, b+1), c = 1
//   whitespace (space, \t \n \v \f \r):           reset (1, 1, 0), c = 0
//   anything else (ASCII punctuation):            identity (0, 1, 0), c = 0
//   combine(x, y) = y.f ? y : (x.f, x.m*y.m, x.a*y.m + y.a, x.c + y.c)
// Entry mr_hash_scan writes h1 = H1_INIT*m1 + a1, h2 = H2_INIT*m2 + a2
// (wrapping uint32, stored as int32 bit patterns) and the word-char count c.
// Entry mr_tokenize_hash writes what ops/tokenize.tokenize_and_hash returns:
//   valid[i] = !ws[i] && (i+1 < n ? ws[i+1] : last_is_boundary) && c[i] > 0
//   k1, k2 = valid ? h1, h2 : SENTINEL;  value = valid (int32);  valid (bool)
// The two differ only in their epilogue, a template parameter.
//
// What bounds it. Each input byte is read once; mr_hash_scan writes 12 bytes
// per input byte, mr_tokenize_hash 13 (4 + 4 + 4 + 1); the work is about ten
// integer operations per byte. So both are bound by device-memory bytes: 13
// and 14 per input byte.
//
// Design: one launch, one pass over the input, after one memset of the
// tile status words.
//  - Tiles and tickets. A block scans one 4 KiB tile (256 threads x 16
//    bytes, one 16-byte load each). It takes the tile's index from a global
//    atomic ticket, not from blockIdx, so every tile it may wait on belongs
//    to a block that is already running: the wait below always ends.
//  - Decoupled look-back. The block folds its tile (each thread its 16
//    bytes, then a block scan) and publishes the tile's aggregate at once.
//    Warp 0 then reads the status of the 32 preceding tiles at a time,
//    combines their elements in stream order, and stops at the nearest one
//    that published an inclusive prefix; the tile then publishes its own
//    inclusive prefix. The reset short-circuit is the monoid's own property,
//    combine(x, y) == y whenever y.f: a tile that holds a whitespace byte
//    publishes its aggregate as its inclusive prefix at once, with no
//    look-back, and look-back stops there. On text nearly every tile does,
//    so a tile waits for at most its neighbour; only a whitespace-free run
//    chains tiles, 32 per step. A tile whose first byte is whitespace needs
//    no carry at all and skips the look-back.
//  - Publishing a 24-byte element, which no single atomic covers. Each tile
//    has two payload slots (aggregate, inclusive), each written once per
//    launch, and one 32-bit status word (EMPTY -> AGGREGATE -> INCLUSIVE, or
//    EMPTY -> INCLUSIVE). The publisher (one thread) stores the payload, then
//    the status with st.release.gpu: every store before a release is
//    visible to whoever acquires the value it wrote. The reader loads the
//    status with ld.acquire.gpu and only then the slot that status names,
//    with ld.global.cg (from L2, the point of coherence, never a stale L1
//    line). A reader that saw AGGREGATE reads the aggregate slot, which is
//    never written again in that launch, so a later INCLUSIVE cannot tear
//    it. The status words and the ticket are zeroed by cudaMemsetAsync on
//    the stream before each launch (captured by a CUDA graph as well);
//    nothing is allocated here.
//  - Coalesced stores. The outputs of a thread's 16 bytes are 64 consecutive
//    bytes per lane; written straight from registers one warp store would
//    touch 32 pieces of 16 bytes spaced 64 bytes apart. Instead each int32
//    lane is staged in 16 KiB of shared memory (16-byte chunks, slot
//    c ^ ((c >> 2) & 7): conflict-free both when thread t writes chunks
//    4t..4t+3 and when consecutive threads read consecutive chunks) and
//    written with 16-byte streaming stores (st.global.cs: the outputs are
//    not read again by this kernel, so they should not push the input and
//    the status words out of L2), consecutive threads on consecutive
//    addresses. The bool lane of the fused entry is 16 bytes a thread and is
//    stored straight from registers, already coalesced.
//  - Registers. A thread's starting state is one value per lane (h =
//    INIT*m + a of its prefix, and the count): the lanes are produced one
//    after the other from that state, the thread's four input words and two
//    16-bit class masks, four outputs at a time. No per-thread output array
//    is kept, the byte loops walk one input word at a time, and the input
//    words and the prefix wait in shared memory while the block looks back.
//    ptxas then needs about 40 registers and no spill, so six blocks fit on
//    an SM (sm_90a: 65,536 registers), enough to keep most of a 4 MiB
//    chunk's 1,024 tiles in flight at once.
//  - The byte after a thread's last byte (the fused epilogue's next-is-space
//    test) is the next thread's first byte, in shared memory, and across
//    tiles one byte load; no tile waits for the next.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytesPerThread = 16;                // one uint4 load
constexpr int kTile = kThreads * kBytesPerThread;  // bytes per block
constexpr int kChunks = kTile / 4;                 // 16-byte chunks of one int32 lane
constexpr unsigned kAll = 0xffffffffu;

constexpr uint32_t kH1Mult = 0x01000193u;  // FNV-1a prime
constexpr uint32_t kH1Init = 0x811C9DC5u;  // FNV offset basis
constexpr uint32_t kH2Mult = 1000003u;
constexpr uint32_t kH2Init = 0x9E3779B9u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

constexpr uint32_t kEmpty = 0u, kAggregate = 1u, kInclusive = 2u;

struct Elem {
  uint32_t f, m1, a1, m2, a2, c;
};

// The look-back's state in the wrapper's scratch buffer.
struct Scratch {
  uint32_t* ticket;
  uint32_t* status;  // [tiles]
  Elem* agg;         // [tiles]
  Elem* incl;        // [tiles]
};

__device__ __forceinline__ Elem identity() { return {0u, 1u, 0u, 1u, 0u, 0u}; }

// x precedes y in the byte stream.
__device__ __forceinline__ Elem combine(const Elem& x, const Elem& y) {
  if (y.f) return y;
  return {x.f, x.m1 * y.m1, x.a1 * y.m1 + y.a1,
          x.m2 * y.m2, x.a2 * y.m2 + y.a2, x.c + y.c};
}

__device__ __forceinline__ bool is_ws(uint32_t b) { return (b == 32u) | ((b - 9u) <= 4u); }

__device__ __forceinline__ bool is_wc(uint32_t b) {
  const uint32_t lower = b | 32u;
  return (((lower - 97u) <= 25u) & (b < 128u)) | ((b - 48u) <= 9u) | (b == 95u) |
         (b >= 128u);
}

__device__ __forceinline__ Elem shfl_up(const Elem& e, int d) {
  return {__shfl_up_sync(kAll, e.f, d), __shfl_up_sync(kAll, e.m1, d),
          __shfl_up_sync(kAll, e.a1, d), __shfl_up_sync(kAll, e.m2, d),
          __shfl_up_sync(kAll, e.a2, d), __shfl_up_sync(kAll, e.c, d)};
}

__device__ __forceinline__ Elem shfl_idx(const Elem& e, int src) {
  return {__shfl_sync(kAll, e.f, src), __shfl_sync(kAll, e.m1, src),
          __shfl_sync(kAll, e.a1, src), __shfl_sync(kAll, e.m2, src),
          __shfl_sync(kAll, e.a2, src), __shfl_sync(kAll, e.c, src)};
}

__device__ __forceinline__ Elem warp_inclusive_scan(Elem x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Elem y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  return x;
}

// This thread's exclusive prefix inside the block; afterwards
// warp_tot[kWarps - 1] holds the block's aggregate. Every thread of the
// block must call it.
__device__ Elem block_exclusive_scan(const Elem& x, Elem* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Elem inc = warp_inclusive_scan(x, lane);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Elem w = lane < kWarps ? warp_tot[lane] : identity();
    w = warp_inclusive_scan(w, lane);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  Elem in_warp = shfl_up(inc, 1);
  if (lane == 0) in_warp = identity();
  return warp == 0 ? in_warp : combine(warp_tot[warp - 1], in_warp);
}

// ---- publishing and reading a tile's element (see the header) ----

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Called by one thread: the payload first, then the status that names it.
__device__ __forceinline__ void publish(uint32_t* status, Elem* slot, uint32_t flag,
                                        const Elem& e) {
  __stcg(&slot->f, e.f);
  __stcg(&slot->m1, e.m1);
  __stcg(&slot->a1, e.a1);
  __stcg(&slot->m2, e.m2);
  __stcg(&slot->a2, e.a2);
  __stcg(&slot->c, e.c);
  store_release(status, flag);
}

__device__ __forceinline__ Elem read_slot(const Elem* slot) {
  return {__ldcg(&slot->f), __ldcg(&slot->m1), __ldcg(&slot->a1),
          __ldcg(&slot->m2), __ldcg(&slot->a2), __ldcg(&slot->c)};
}

// The exclusive prefix of `tile` (> 0): run by all 32 lanes of one warp.
// Each round reads tiles [end-32, end), lane 31 the nearest.
__device__ Elem look_back(const Scratch& s, int64_t tile, int lane) {
  Elem carry = identity();
  for (int64_t end = tile;; end -= 32) {
    const int64_t j = end - 32 + lane;
    uint32_t st = kInclusive;  // tiles before 0 act as an inclusive identity
    Elem v = identity();
    if (j >= 0) {
      // The block of tile j took its ticket before this one did, so it is
      // running and publishes at least its aggregate without waiting.
      while ((st = load_acquire(s.status + j)) == kEmpty) __nanosleep(32);
      v = read_slot(st == kInclusive ? s.incl + j : s.agg + j);
    }
    const unsigned stops = __ballot_sync(kAll, st == kInclusive || v.f != 0u);
    // Everything before the nearest stop is already inside its element.
    const int nearest = stops ? 31 - __clz(stops) : 0;
    if (lane < nearest) v = identity();
    carry = combine(shfl_idx(warp_inclusive_scan(v, lane), 31), carry);
    if (stops) return carry;
  }
}

// ---- the tile's bytes ----

// The thread's 16 bytes as four little-endian words (zero past n, and a
// zero byte is the identity); returns how many lie inside [0, n).
__device__ __forceinline__ int load16(const uint8_t* __restrict__ in, int64_t n,
                                      int64_t base, uint32_t (&w)[4]) {
  if (base + kBytesPerThread <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(in + base);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return kBytesPerThread;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  const int count = base < n ? static_cast<int>(n - base) : 0;
#pragma unroll
  for (int i = 0; i < kBytesPerThread; ++i) {
    if (i < count) w[i >> 2] |= static_cast<uint32_t>(in[base + i]) << (8 * (i & 3));
  }
  return count;
}

__device__ __forceinline__ bool bit(uint32_t mask, int i) { return (mask >> i) & 1u; }

// ---- staging an int32 lane through shared memory ----

__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 2) & 7); }

// Writes the staged lane to out[tile_base, tile_base + kTile) cut at n: 16-byte
// stores, consecutive threads on consecutive chunks. Syncs before reading the
// stage and after, so the next lane may fill it.
__device__ __forceinline__ void flush_lane(const uint4* stage, uint32_t* __restrict__ out,
                                           int64_t tile_base, int64_t n) {
  __syncthreads();
  const int64_t left = n - tile_base;
#pragma unroll
  for (int k = 0; k < kChunks / kThreads; ++k) {
    const int c = k * kThreads + static_cast<int>(threadIdx.x);
    const int64_t word = 4 * static_cast<int64_t>(c);
    const uint4 v = stage[swz(c)];
    if (word + 4 <= left) {
      __stcs(reinterpret_cast<uint4*>(out + tile_base + word), v);
    } else if (word < left) {
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (word + r < left) __stcs(out + tile_base + word + r, vv[r]);
      }
    }
  }
  __syncthreads();
}

// One hash lane from the thread's starting hash h and its four input words
// (in shared memory). In the fused epilogue a byte that ends no token gets
// SENTINEL. The byte loops here and in the kernel walk one word at a time
// and are not unrolled across words, which keeps their live values to one
// word's worth.
template <bool kFused>
__device__ __forceinline__ void stage_hash(uint4* stage, const uint32_t* words, uint32_t ws,
                                           uint32_t wc, uint32_t vmask, uint32_t h,
                                           uint32_t mult, uint32_t init) {
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const uint32_t word = words[q];
    uint32_t o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * q + r;
      if (bit(ws, i)) {
        h = init;
      } else if (bit(wc, i)) {
        h = h * mult + (word >> (8 * r) & 0xffu) + 1u;
      }
      o[r] = (!kFused || bit(vmask, i)) ? h : kSentinel;
    }
    stage[swz(4 * static_cast<int>(threadIdx.x) + q)] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// out0, out1, out2: h1, h2, cnt (mr_hash_scan) or k1, k2, value
// (mr_tokenize_hash, which also writes the bool lane valid_out).
//
// Between phases a thread keeps little more than its two class masks in
// registers: its input words and its exclusive prefix wait in shared memory
// (s_in, s_excl), so neither the look-back nor the three output passes hold
// them, or the 16 byte values derived from them, in registers.
template <bool kFused>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint8_t* __restrict__ in, int64_t n, uint32_t* __restrict__ out0,
            uint32_t* __restrict__ out1, uint32_t* __restrict__ out2,
            uint8_t* __restrict__ valid_out, Scratch s, int last_is_boundary) {
  __shared__ uint4 stage[kChunks];
  __shared__ uint4 s_in[kThreads];
  __shared__ Elem s_excl[kThreads];
  __shared__ Elem warp_tot[kWarps];
  __shared__ Elem s_carry;
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_next;  // fused: the byte after the tile
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_tile = atomicAdd(s.ticket, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t tile_base = tile * kTile;
  const int64_t base = tile_base + static_cast<int64_t>(tid) * kBytesPerThread;

  const uint32_t* words = reinterpret_cast<const uint32_t*>(s_in + tid);
  uint32_t ws = 0u, wc = 0u;
  int count;
  {
    uint32_t w[4];
    count = load16(in, n, base, w);
    s_in[tid] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  {
    Elem x = identity();
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const uint32_t word = words[q];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t b = word >> (8 * r) & 0xffu;
        const bool s_ = is_ws(b), c_ = is_wc(b);
        ws |= static_cast<uint32_t>(s_) << (4 * q + r);
        wc |= static_cast<uint32_t>(c_) << (4 * q + r);
        if (s_) {
          x = {1u, 1u, 0u, 1u, 0u, 0u};
        } else if (c_) {
          x.m1 *= kH1Mult;
          x.a1 = x.a1 * kH1Mult + b + 1u;
          x.m2 *= kH2Mult;
          x.a2 = x.a2 * kH2Mult + b + 1u;
          x.c += 1u;
        }
      }
    }
    if (kFused && tid == 0) s_next = tile_base + kTile < n ? in[tile_base + kTile] : 0u;
    s_excl[tid] = block_exclusive_scan(x, warp_tot);  // syncs: s_in, s_next visible
  }

  if (warp == 0) {
    const bool inclusive_now = tile == 0 || warp_tot[kWarps - 1].f != 0u;
    if (lane == 0) {
      publish(s.status + tile, inclusive_now ? s.incl + tile : s.agg + tile,
              inclusive_now ? kInclusive : kAggregate, warp_tot[kWarps - 1]);
    }
    // Thread 0's first bit: a tile opening on whitespace needs no carry.
    const bool opens_on_ws = __shfl_sync(kAll, ws & 1u, 0) != 0u;
    Elem carry = identity();
    if (tile > 0 && !opens_on_ws) carry = look_back(s, tile, lane);
    if (lane == 0) {
      s_carry = carry;
      if (!inclusive_now) {
        publish(s.status + tile, s.incl + tile, kInclusive, combine(carry, warp_tot[kWarps - 1]));
      }
    }
  }
  __syncthreads();
  // This thread's exclusive prefix in the chunk, as the three lanes' values.
  uint32_t h1, h2, c;
  {
    const Elem p = combine(s_carry, s_excl[tid]);
    h1 = kH1Init * p.m1 + p.a1;
    h2 = kH2Init * p.m2 + p.a2;
    c = p.c;
  }

  // The count lane; in the fused epilogue the token-end mask and value lane.
  uint32_t vmask = 0u;
  uint32_t ext = 0u;  // ws, then at bit `count` whether the next byte is a boundary
  if (kFused) {
    const uint32_t next = tid + 1 < kThreads ? s_in[tid + 1].x & 0xffu : s_next;
    const bool next_ws = base + count < n ? is_ws(next) : last_is_boundary != 0;
    ext = ws | (static_cast<uint32_t>(next_ws) << count);
  }
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    uint32_t o[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * q + r;
      c = bit(ws, i) ? 0u : c + (wc >> i & 1u);
      if (kFused) {
        const bool v = !bit(ws, i) && bit(ext, i + 1) && c > 0u;
        vmask |= static_cast<uint32_t>(v) << i;
        o[r] = v;
      } else {
        o[r] = c;
      }
    }
    stage[swz(4 * tid + q)] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  flush_lane(stage, out2, tile_base, n);
  if (kFused) {
    uint32_t vb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      vb[q] = (vmask >> (4 * q) & 1u) | (vmask >> (4 * q + 1) & 1u) << 8 |
              (vmask >> (4 * q + 2) & 1u) << 16 | (vmask >> (4 * q + 3) & 1u) << 24;
    }
    if (count == kBytesPerThread) {
      __stcs(reinterpret_cast<uint4*>(valid_out + base), make_uint4(vb[0], vb[1], vb[2], vb[3]));
    } else {
      for (int i = 0; i < count; ++i) valid_out[base + i] = static_cast<uint8_t>(bit(vmask, i));
    }
  }
  stage_hash<kFused>(stage, words, ws, wc, vmask, h1, kH1Mult, kH1Init);
  flush_lane(stage, out0, tile_base, n);
  stage_hash<kFused>(stage, words, ws, wc, vmask, h2, kH2Mult, kH2Init);
  flush_lane(stage, out1, tile_base, n);
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// Scratch layout: the ticket (16 bytes), the status words (rounded up to
// 16 bytes) — together the part zeroed before each launch — then the
// aggregate and the inclusive slots.
int64_t zeroed_bytes(int64_t tiles) { return (16 + 4 * tiles + 15) / 16 * 16; }

template <bool kFused>
int launch(const void* chunk, void* out0, void* out1, void* out2, void* valid, void* scratch,
           long long n, int last_is_boundary, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = num_tiles(n);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(scratch, 0, zeroed_bytes(tiles), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint8_t* raw = static_cast<uint8_t*>(scratch);
  Elem* slots = reinterpret_cast<Elem*>(raw + zeroed_bytes(tiles));
  const Scratch s{reinterpret_cast<uint32_t*>(raw), reinterpret_cast<uint32_t*>(raw + 16),
                  slots, slots + tiles};
  scan_kernel<kFused><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(chunk), n, static_cast<uint32_t*>(out0),
      static_cast<uint32_t*>(out1), static_cast<uint32_t*>(out2),
      static_cast<uint8_t*>(valid), s, last_is_boundary);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes per tile, for the wrapper to check against its own constant.
long long mr_hash_scan_tile_bytes() { return kTile; }

// Bytes of scratch either entry needs for an n-byte chunk.
long long mr_hash_scan_scratch_bytes(long long n) {
  const int64_t tiles = num_tiles(n);
  return zeroed_bytes(tiles) + 2 * tiles * static_cast<long long>(sizeof(Elem));
}

// On `stream`: one memset of the look-back state, then one kernel launch;
// returns the first CUDA error. chunk: n bytes, 16-byte aligned; h1, h2, cnt:
// n 32-bit words each, 16-byte aligned; scratch: mr_hash_scan_scratch_bytes(n)
// bytes, 16-byte aligned. Nothing is allocated and nothing is synchronised.
int mr_hash_scan(const void* chunk, void* h1, void* h2, void* cnt, void* scratch,
                 long long n, void* stream) {
  return launch<false>(chunk, h1, h2, cnt, nullptr, scratch, n, 0, stream);
}

// The same scan with the token-end epilogue: k1, k2, value (n 32-bit words
// each) and valid (n bytes), all 16-byte aligned; last_is_boundary is 0 or 1.
int mr_tokenize_hash(const void* chunk, void* k1, void* k2, void* value, void* valid,
                     void* scratch, long long n, int last_is_boundary, void* stream) {
  return launch<true>(chunk, k1, k2, value, valid, scratch, n, last_is_boundary, stream);
}

}  // extern "C"
