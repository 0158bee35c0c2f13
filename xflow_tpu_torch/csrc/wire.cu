// K6 — the dictionary-wire decode: the flat tiered planes of
// io/compact.py::CompactBatch.wire, as they come off the host, back into
// the padded [B, K] planes that K1 (score.cu) and K2 (train.cu) read.
//
// Replaces this XLA-lowered region of the JAX reference (it has no
// Pallas kernels, so its jnp regions are what a port turns into kernels
// — ROADMAP Queue B):
//   B4 dict  xflow_tpu/parallel/step.py:621-743 TrainStep._expand_dict_wire,
//            its cold half: an exclusive cumsum of the per-row counts
//            gives the row starts; each entry's flag bit picks a tier;
//            the entry's rank among the 1s (or the 0s) indexes the u16
//            dictionary indices, resolved through the dictionary keys
//            (or the raw tail keys); the label and weight bitmaps unpack.
//   B4 dict, hot  step.py:744-766, the same function's hot half: per-row
//            hot counts, a tier bitmap (1 = u8 id), the u8 ids and the
//            large tier, u16 ids or (H <= 2^12) u12 ids as u8 lows plus
//            packed nibble highs (even entry: low nibble, odd: high).
//   B4s      step.py:691-701 flat_slots, applied to cw_cs (:727-731) and
//            cw_hs (:758-762): the field-id streams of models that read
//            slots (MVM), u8 as the host clamps them, gathered at the same
//            row starts into [B, K] and [B, KH] with 0 past each row's
//            count (each entry clipped to its stream's capacity).
//   The consolidation plan that region also emits (cold_uidx, ...) has
//   no consumer in the port: dense cold_consolidate runs the plain dense
//   step (ops/train.py), so K6 emits the compact-wire planes only.
//
// Inputs (device, contiguous):  cc u8 [B] per-row counts; cf u8
// [cf_bytes] the flag bitmap, LSB first, 1 = dictionary entry; ci u16
// [cap_i] dictionary indices; cu, ct the dictionary and tail keys, u24
// as [n, 3] little-endian bytes (key_bytes 3) or u32 (key_bytes 4);
// lb, wb u8 [ceil(B/8)] label and weight bitmaps, LSB first.  Every
// plane's capacity may exceed its count (plane_cap), and the flag bits
// past the last real entry are 0: nothing ranks past the counts.
// Outputs: ckeys i32 [B, K] (-1 on padding), labels u8 [B], weights u8
// [B].  Scratch: row_start i32 [B], word_prefix i32 [ceil(cf_bytes/4)],
// tiles i32 [xf_dict_decode_tiles(...)] (a sum a scan tile).
// The hot tiers (KH > 0): hc u8 [B] per-row hot counts; hf u8 the tier
// bitmap, 1 = u8 tier; h8 u8 [cap8]; hx u16 [capx] (hx_u16) or u8 lows
// [capx] with hxh u8 [ceil(capx/2)] nibble highs; output hot i32
// [B, KH] (-1 on padding); scratch hot_row_start i32 [B], hot_prefix
// i32 [ceil(hf_bytes/4)].  The same rank-by-popcount rule picks the
// tier and the entry; an empty plane is never read.  The field streams
// (cs not null): cs u8 [cap_cs], and with the hot tiers hs u8 [cap_hs];
// outputs fields u8 [B, K] and hot_fields u8 [B, KH] (0 on padding).
// They reuse the scan's row starts and ride the decode phase: one byte
// read and one written per entry, no new pass.
//
// One cooperative launch (one wrapper call, ops/wire.py): a grid of
// as many 256-thread blocks as the card holds at once, in three phases
// split by two grid-wide barriers (grid.sync(), the pattern K4's slice
// form uses; a refused cooperative launch returns its error, and the
// wrapper raises).
//   1. Tile sums.  Each plane that is scanned (cc, cf, and with the hot
//      tiers hc, hf) is cut into tiles of kTileBytes = 4,096 bytes:
//      4,096 rows of counts, or 1,024 flag words.  The
//      blocks take the tiles of all four planes in turn; a thread loads
//      one 16-byte chunk of its tile (one vector load where the plane's
//      base is 16-byte aligned and the chunk whole, byte loads
//      elsewhere), sums its 16 counts or the popcounts of its 4 words,
//      and the block's sum goes to the tile's entry in `tiles`.
//   2. Prefixes.  Each tile's offset is the sum of the earlier tiles of
//      its plane (a block reduction over their entries); the block
//      scans its chunks' sums again and each thread writes its chunk's
//      16 row starts or 4 word prefixes.
//   3. Decode, a thread per (row, col), the grid striding over them:
//      col >= cc[row] writes -1; else e = row_start[row] + col, its
//      word's prefix plus the popcount of the bits below e in that word
//      (one 32-bit load where the bitmap is 4-byte aligned and the word
//      whole) is its rank among the dictionary entries, e - rank its
//      rank among the tail entries; the thread writes cu[ci[rank]] or
//      ct[e - rank].  Threads i < B*KH decode hot entry i the same way
//      (h8[rank] or the large tier's e - rank), and threads i < B also
//      unpack the label and weight bits; with the field streams, each
//      (row, col) thread also writes its field id (cs[row_start[row] +
//      col]) and each hot thread its hot field id.
// Every index is clipped to its plane's capacity (a zero-length plane
// is never read), as the reference clips: malformed planes cannot read
// out of bounds, and the outputs are the plain version's bytes.
//
// Bound.  Bytes: the planes read once (cc B, cf, ci 2 n_dict_occ, ct 3
// or 4 per tail entry, cu 3 or 4 per dictionary entry, lb, wb) and
// the outputs written once (4 B K + 2 B): about 17 MB, 0.005 ms at
// 3.35 TB/s, for the repo's FM batches (B = 65,536, K = 40); the hot
// tiers add hc, hf, about 1.2 bytes per hot entry and 4 B KH out; the
// field streams 1 B per real entry in and 1 B per slot out.  A few
// integer operations per byte: bytes bound it.  What stays above the
// bound is one launch floor, two grid-wide barriers and the decode's
// dependent reads (row start, flag word and prefix, then the key).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // bytes a thread loads in the scan phases
// a scan tile: 4,096 rows of counts, or 1,024 flag words
constexpr int kTileBytes = kThreads * kChunk;
constexpr int kPlanes = 4;  // cc, cf, hc, hf

// A plane the scan phases cut into tiles: `bytes` of u8 counts (one
// item a byte: its count) or of an LSB-first bitmap (one item a 32-bit
// word: its popcount), and where its items' exclusive prefixes go.
struct ScanPlane {
  const uint8_t* data;
  long long bytes;
  int items;
  int words;   // 1: bitmap words, 0: counts
  int aligned; // the base is 16-byte aligned: whole chunks load as one
  int* prefix;
  int first_tile;
};

struct Planes {
  ScanPlane p[kPlanes];
  int tiles;  // all planes'
};

long long tiles_of(long long bytes) {
  return (bytes + kTileBytes - 1) / kTileBytes;
}

bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<std::uintptr_t>(p) & (bytes - 1u)) == 0;
}

// Chunk c (kChunk bytes from c * kChunk) of a plane, zeros past its end.
__device__ __forceinline__ uint4 load_chunk(const ScanPlane& pl, long long c) {
  const long long at = c * kChunk;
  if (pl.aligned && at + kChunk <= pl.bytes) {
    return __ldg(reinterpret_cast<const uint4*>(pl.data) + c);
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < kChunk && at + i < pl.bytes; ++i) {
    w[i >> 2] |= static_cast<unsigned>(pl.data[at + i]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int chunk_sum(const uint4& v, int words) {
  if (words) return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  int s = 0;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // the four bytes of a word summed as two 16-bit lanes
    const unsigned pairs = (w[i] & 0x00FF00FFu) + ((w[i] >> 8) & 0x00FF00FFu);
    s += static_cast<int>((pairs & 0xFFFFu) + (pairs >> 16));
  }
  return s;
}

// Exclusive scan of one int per thread over the block (blockDim.x a
// multiple of 32); *total gets the block's sum.  Every thread calls it.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

// Tile t of all planes: its plane, and its index within the plane.
__device__ __forceinline__ int plane_of(const Planes& ps, int t, int* local) {
  int k = kPlanes - 1;
  while (k > 0 && t < ps.p[k].first_tile) --k;
  *local = t - ps.p[k].first_tile;
  return k;
}

// Word w of the flag bitmap: bytes 4w..4w+3, little-endian, so bit e of
// the stream (byte e >> 3, bit e & 7) is bit e & 31 of word e >> 5; one
// load where the base is 4-byte aligned and the word whole.
__device__ __forceinline__ unsigned flag_word(const uint8_t* cf,
                                              long long cf_bytes, int aligned,
                                              long long w) {
  const long long base = w * 4;
  if (aligned && base + 4 <= cf_bytes) {
    return __ldg(reinterpret_cast<const unsigned*>(cf) + w);
  }
  unsigned v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (base + j < cf_bytes) v |= static_cast<unsigned>(cf[base + j]) << (8 * j);
  }
  return v;
}

__device__ __forceinline__ int read_key(const uint8_t* plane, int i,
                                        int key_bytes) {
  if (key_bytes == 4) return reinterpret_cast<const int*>(plane)[i];
  const uint8_t* p = plane + 3LL * i;
  return static_cast<int>(p[0]) | (static_cast<int>(p[1]) << 8) |
         (static_cast<int>(p[2]) << 16);
}

// The rank of flag bit e among the 1s before it (its word's prefix
// plus the bits below it), and the bit itself.
__device__ __forceinline__ int flag_rank(const uint8_t* flags,
                                         long long flag_bytes, int aligned,
                                         const int* prefix, long long e,
                                         bool& set) {
  const long long w = e >> 5;
  const int bit = static_cast<int>(e & 31);
  const unsigned word = flag_word(flags, flag_bytes, aligned, w);
  set = (word >> bit) & 1u;
  return __ldcg(prefix + w) + __popc(word & ((1u << bit) - 1u));
}

// The decode's planes (header), by value.
struct Decode {
  const uint8_t* cc;
  int b, k;
  const int* row_start;
  const uint8_t* cf;
  long long cf_bytes;
  int cf_aligned;
  const int* word_prefix;
  const uint16_t* ci;
  int cap_i;
  const uint8_t* cu;
  int cap_d;
  const uint8_t* ct;
  int cap_t, key_bytes;
  const uint8_t* lb;
  const uint8_t* wb;
  int* ckeys;
  uint8_t* labels;
  uint8_t* weights;
  int kh;
  const uint8_t* hc;
  const int* hot_row_start;
  const uint8_t* hf;
  long long hf_bytes;
  int hf_aligned;
  const int* hot_prefix;
  const uint8_t* h8;
  int cap8;
  const void* hx;
  int capx, hx_u16;
  const uint8_t* hxh;
  int caph;
  int* hot;
  const uint8_t* cs;
  int cap_cs;
  uint8_t* fields;
  const uint8_t* hs;
  int cap_hs;
  uint8_t* hot_fields;
};

// Hot entry (row, col): -1 past the row's count; else the u8 tier's id
// or the large tier's (u16, or u12 = u8 low | nibble high << 8), every
// index clipped to its plane.
__device__ __forceinline__ int hot_id(const Decode& a, int row, int col) {
  if (col >= a.hc[row]) return -1;
  const long long cap_bits = a.hf_bytes * 8;
  if (cap_bits == 0) return 0;
  long long e = static_cast<long long>(__ldcg(a.hot_row_start + row)) + col;
  if (e > cap_bits - 1) e = cap_bits - 1;
  bool small;
  const int rank = flag_rank(a.hf, a.hf_bytes, a.hf_aligned, a.hot_prefix, e, small);
  if (small) return a.cap8 > 0 ? a.h8[min(rank, a.cap8 - 1)] : 0;
  if (a.capx == 0) return 0;
  const long long r0 = e - rank;
  const int r = static_cast<int>(r0 < a.capx - 1 ? r0 : a.capx - 1);
  if (a.hx_u16) return static_cast<const uint16_t*>(a.hx)[r];
  int id = static_cast<const uint8_t*>(a.hx)[r];
  if (r / 2 < a.caph) id |= ((a.hxh[r / 2] >> (4 * (r & 1))) & 0xF) << 8;
  return id;
}

// Phase 3 (header) for item i.
__device__ __forceinline__ void decode_item(const Decode& a, long long i) {
  const long long total = static_cast<long long>(a.b) * a.k;
  if (i < total) {
    // 32-bit: the wrapper keeps B * K below 2^31
    const int row = static_cast<int>(i) / a.k;
    const int col = static_cast<int>(i) - row * a.k;
    int key = -1;
    int field = 0;
    if (col < a.cc[row]) {
      const long long e_raw = static_cast<long long>(__ldcg(a.row_start + row)) + col;
      if (a.cap_cs > 0) field = a.cs[e_raw < a.cap_cs - 1 ? e_raw : a.cap_cs - 1];
      key = 0;
      const long long cap_bits = a.cf_bytes * 8;
      if (cap_bits > 0) {
        const long long e = e_raw < cap_bits - 1 ? e_raw : cap_bits - 1;
        bool in_dict;
        const int rank =
            flag_rank(a.cf, a.cf_bytes, a.cf_aligned, a.word_prefix, e, in_dict);
        if (in_dict) {
          const int idx = a.cap_i > 0 ? a.ci[min(rank, a.cap_i - 1)] : 0;
          if (a.cap_d > 0) key = read_key(a.cu, min(idx, a.cap_d - 1), a.key_bytes);
        } else if (a.cap_t > 0) {
          const long long r = e - rank;
          key = read_key(a.ct, static_cast<int>(r < a.cap_t - 1 ? r : a.cap_t - 1),
                         a.key_bytes);
        }
      }
    }
    a.ckeys[i] = key;
    if (a.fields != nullptr) a.fields[i] = static_cast<uint8_t>(field);
  }
  if (i < static_cast<long long>(a.b) * a.kh) {
    const int row = static_cast<int>(i) / a.kh;
    const int col = static_cast<int>(i) - row * a.kh;
    a.hot[i] = hot_id(a, row, col);
    if (a.hot_fields != nullptr) {
      int field = 0;
      if (col < a.hc[row] && a.cap_hs > 0) {
        const long long e = static_cast<long long>(__ldcg(a.hot_row_start + row)) + col;
        field = a.hs[e < a.cap_hs - 1 ? e : a.cap_hs - 1];
      }
      a.hot_fields[i] = static_cast<uint8_t>(field);
    }
  }
  if (i < a.b) {
    a.labels[i] = (a.lb[i >> 3] >> (i & 7)) & 1;
    a.weights[i] = (a.wb[i >> 3] >> (i & 7)) & 1;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const __grid_constant__ Planes ps, int* __restrict__ tiles,
              const __grid_constant__ Decode a, long long items) {
  cg::grid_group grid = cg::this_grid();
  // 1. each tile's sum
  for (int t = blockIdx.x; t < ps.tiles; t += gridDim.x) {
    int local = 0;
    const ScanPlane& pl = ps.p[plane_of(ps, t, &local)];
    const long long c = static_cast<long long>(local) * kThreads + threadIdx.x;
    int total = 0;
    block_exclusive_scan(chunk_sum(load_chunk(pl, c), pl.words), &total);
    if (threadIdx.x == 0) tiles[t] = total;
  }
  grid.sync();
  // 2. each item's exclusive prefix
  for (int t = blockIdx.x; t < ps.tiles; t += gridDim.x) {
    int local = 0;
    const ScanPlane& pl = ps.p[plane_of(ps, t, &local)];
    int before = 0;
    for (int u = threadIdx.x; u < local; u += kThreads) {
      before += __ldcg(tiles + pl.first_tile + u);
    }
    int offset = 0;
    block_exclusive_scan(before, &offset);
    const long long c = static_cast<long long>(local) * kThreads + threadIdx.x;
    const uint4 v = load_chunk(pl, c);
    int unused = 0;
    int run = offset + block_exclusive_scan(chunk_sum(v, pl.words), &unused);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    if (pl.words) {
      const long long first = c * (kChunk / 4);
#pragma unroll
      for (int i = 0; i < kChunk / 4; ++i) {
        if (first + i < pl.items) pl.prefix[first + i] = run;
        run += __popc(w[i]);
      }
    } else {
      const long long first = c * kChunk;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (first + i < pl.items) pl.prefix[first + i] = run;
        run += static_cast<int>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu);
      }
    }
  }
  grid.sync();
  // 3. the decode
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < items; i += stride) {
    decode_item(a, i);
  }
}

// The cooperative grid: as many blocks as the card holds at once (the
// occupancy of the current device, kept per device), and no more than
// the decode's items need.
int grid_for(long long items, int* grid) {
  static int cached_dev = -1;
  static int resident = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * per_sm;
    cached_dev = dev;
  }
  const long long want = (items + kThreads - 1) / kThreads;
  *grid = static_cast<int>(want < resident ? (want > 0 ? want : 1) : resident);
  return 0;
}

ScanPlane scan_plane(const uint8_t* data, long long bytes, bool words,
                     int* prefix, int first_tile) {
  ScanPlane p{};
  p.data = data;
  p.bytes = data != nullptr ? bytes : 0;
  p.words = words ? 1 : 0;
  p.items = static_cast<int>(words ? (p.bytes + 3) / 4 : p.bytes);
  p.aligned = data != nullptr && aligned_to(data, 16) ? 1 : 0;
  p.prefix = prefix;
  p.first_tile = first_tile;
  return p;
}

}  // namespace

// Int32 entries of the tile-sum scratch xf_dict_decode needs: one a
// kTileBytes tile of cc (b bytes), cf, and with kh > 0 hc and hf.
extern "C" long long xf_dict_decode_tiles(int b, long long cf_bytes, int kh,
                                          long long hf_bytes) {
  long long n = tiles_of(b) + tiles_of(cf_bytes);
  if (kh > 0) n += tiles_of(b) + tiles_of(hf_bytes);
  return n;
}

// K6 on `stream`: one cooperative launch (header); kh = 0 means no hot
// tiers (their pointers unread); cs null means no field streams (cs,
// fields, hs, hot_fields unread).  `tiles` holds
// xf_dict_decode_tiles(...) int32 entries.  Returns the launch's error
// (0 = launched; a refused cooperative launch returns its code).
extern "C" int xf_dict_decode(const uint8_t* cc, int b, int k,
                              const uint8_t* cf, long long cf_bytes,
                              const uint16_t* ci, int cap_i, const uint8_t* cu,
                              int cap_d, const uint8_t* ct, int cap_t,
                              int key_bytes, const uint8_t* lb,
                              const uint8_t* wb, int* row_start,
                              int* word_prefix, int* ckeys, uint8_t* labels,
                              uint8_t* weights, int kh, const uint8_t* hc,
                              const uint8_t* hf, long long hf_bytes,
                              const uint8_t* h8, int cap8, const void* hx,
                              int capx, int hx_u16, const uint8_t* hxh,
                              int caph, int* hot_row_start, int* hot_prefix,
                              int* hot, const uint8_t* cs, int cap_cs,
                              uint8_t* fields, const uint8_t* hs, int cap_hs,
                              uint8_t* hot_fields, int* tiles, void* stream) {
  if (b <= 0) return 0;
  if (kh <= 0) {
    kh = 0;
    hc = nullptr;
    hf = nullptr;
    hf_bytes = 0;
  }
  if (cs == nullptr) fields = nullptr;
  if (cs == nullptr || kh == 0) hot_fields = nullptr;
  Planes ps{};
  int first = 0;
  ps.p[0] = scan_plane(cc, b, false, row_start, first);
  first += static_cast<int>(tiles_of(ps.p[0].bytes));
  ps.p[1] = scan_plane(cf, cf_bytes, true, word_prefix, first);
  first += static_cast<int>(tiles_of(ps.p[1].bytes));
  ps.p[2] = scan_plane(hc, kh > 0 ? b : 0, false, hot_row_start, first);
  first += static_cast<int>(tiles_of(ps.p[2].bytes));
  ps.p[3] = scan_plane(hf, hf_bytes, true, hot_prefix, first);
  first += static_cast<int>(tiles_of(ps.p[3].bytes));
  ps.tiles = first;
  const Decode a{cc,     b,      k,      row_start, cf,       cf_bytes,
                 aligned_to(cf, 4) ? 1 : 0,          word_prefix,
                 ci,     cap_i,  cu,     cap_d,     ct,       cap_t,
                 key_bytes,      lb,     wb,        ckeys,    labels,
                 weights,        kh,     hc,        hot_row_start,
                 hf,     hf_bytes,       hf != nullptr && aligned_to(hf, 4) ? 1 : 0,
                 hot_prefix,     h8,     cap8,      hx,       capx,
                 hx_u16, hxh,    caph,   hot,       cs,       cap_cs,
                 fields, hs,     cap_hs, hot_fields};
  const long long total = static_cast<long long>(b) * k;
  long long items = total > b ? total : b;
  const long long hot_total = static_cast<long long>(b) * kh;
  if (hot_total > items) items = hot_total;
  int grid = 0;
  int rc = grid_for(items, &grid);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, decode_kernel, ps, tiles, a, items);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
