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
//   The consolidation plan that region also emits (cold_uidx, ...) has
//   no consumer in the port: dense cold_consolidate runs the plain dense
//   step (ops/train.py), so K6 emits the compact-wire planes only.  Hot
//   slots are not decoded: LR and FM read none, and none ship.
//
// Inputs (device, contiguous):  cc u8 [B] per-row counts; cf u8
// [cf_bytes] the flag bitmap, LSB first, 1 = dictionary entry; ci u16
// [cap_i] dictionary indices; cu, ct the dictionary and tail keys, u24
// as [n, 3] little-endian bytes (key_bytes 3) or u32 (key_bytes 4);
// lb, wb u8 [ceil(B/8)] label and weight bitmaps, LSB first.  Every
// plane's capacity may exceed its count (plane_cap), and the flag bits
// past the last real entry are 0: nothing ranks past the counts.
// Outputs: ckeys i32 [B, K] (-1 on padding), labels u8 [B], weights u8
// [B].  Scratch: row_start i32 [B], word_prefix i32 [ceil(cf_bytes/4)].
// The hot tiers (KH > 0): hc u8 [B] per-row hot counts; hf u8 the tier
// bitmap, 1 = u8 tier; h8 u8 [cap8]; hx u16 [capx] (hx_u16) or u8 lows
// [capx] with hxh u8 [ceil(capx/2)] nibble highs; output hot i32
// [B, KH] (-1 on padding); scratch hot_row_start i32 [B], hot_prefix
// i32 [ceil(hf_bytes/4)].  The same rank-by-popcount rule picks the
// tier and the entry; an empty plane is never read.
//
// Launches (one wrapper call, ops/wire.py):
//   1. scan, ONE block of 1024 threads: row_start = exclusive scan of
//      cc, and word_prefix = exclusive scan of the popcount of each
//      32-bit word of cf (and the same two scans of hc and hf).  Each
//      thread sums a contiguous chunk, one block-wide scan of the 1024
//      chunk sums (warp shuffles + shared memory), then the thread
//      writes its chunk's prefixes.
//   2. decode, a thread per (row, col): col >= cc[row] writes -1; else
//      e = row_start[row] + col, its word's prefix plus the popcount of
//      the bits below e in that word is its rank among the dictionary
//      entries, e - rank its rank among the tail entries; the thread
//      writes cu[ci[rank]] or ct[e - rank].  Threads i < B*KH decode hot
//      entry i the same way (h8[rank] or the large tier's e - rank), and
//      threads i < B also unpack the label and weight bits.
// Every index is clipped to its plane's capacity (a zero-length plane
// is never read), as the reference clips: malformed planes cannot read
// out of bounds.
//
// Bound.  Bytes: the planes read once (cc B, cf, ci 2 n_dict_occ, ct 3
// or 4 per tail entry, cu 3 or 4 per dictionary entry, lb, wb) and
// the outputs written once (4 B K + 2 B): about 17 MB, 0.005 ms at
// 3.35 TB/s, for the repo's FM batches (B = 65,536, K = 40); the hot
// tiers add hc, hf, about 1.2 bytes per hot entry and 4 B KH out.  A few
// integer operations per byte: bytes bound it.  The one-block scan
// (about 65,536 counts and 82,000 flag words) is latency-bound and
// costs more than its bytes; a multi-block scan, or fusing the decode
// into K1 and K2, is later work (perf_opt).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

int grid_for(long long items) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

// Word w of the flag bitmap: bytes 4w..4w+3, little-endian, so bit e of
// the stream (byte e >> 3, bit e & 7) is bit e & 31 of word e >> 5.
__device__ __forceinline__ unsigned flag_word(const uint8_t* cf,
                                              long long cf_bytes,
                                              long long w) {
  unsigned v = 0;
  const long long base = w * 4;
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

// Exclusive scans over one block: starts = scan of the b counts, and
// prefix = scan of the popcounts of the n_words flag words.
__device__ void scan_plane(const uint8_t* counts, int b, const uint8_t* flags,
                           long long flag_bytes, int n_words, int* starts,
                           int* prefix) {
  const int t = threadIdx.x;
  int total = 0;
  {
    const int per = (b + kScanThreads - 1) / kScanThreads;
    const int lo = min(b, t * per);
    const int hi = min(b, lo + per);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += counts[i];
    int run = block_exclusive_scan(sum, &total);
    for (int i = lo; i < hi; ++i) {
      starts[i] = run;
      run += counts[i];
    }
  }
  {
    const int per = (n_words + kScanThreads - 1) / kScanThreads;
    const int lo = min(n_words, t * per);
    const int hi = min(n_words, lo + per);
    int sum = 0;
    for (int w = lo; w < hi; ++w) sum += __popc(flag_word(flags, flag_bytes, w));
    int run = block_exclusive_scan(sum, &total);
    for (int w = lo; w < hi; ++w) {
      prefix[w] = run;
      run += __popc(flag_word(flags, flag_bytes, w));
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint8_t* __restrict__ cc, int b,
            const uint8_t* __restrict__ cf, long long cf_bytes, int n_words,
            int* __restrict__ row_start, int* __restrict__ word_prefix,
            const uint8_t* __restrict__ hc, const uint8_t* __restrict__ hf,
            long long hf_bytes, int n_hwords, int* __restrict__ hot_row_start,
            int* __restrict__ hot_prefix) {
  scan_plane(cc, b, cf, cf_bytes, n_words, row_start, word_prefix);
  if (hc != nullptr) {
    scan_plane(hc, b, hf, hf_bytes, n_hwords, hot_row_start, hot_prefix);
  }
}

// The rank of flag bit e among the 1s before it (its word's prefix
// plus the bits below it), and the bit itself.
__device__ __forceinline__ int flag_rank(const uint8_t* flags,
                                         long long flag_bytes,
                                         const int* prefix, long long e,
                                         bool& set) {
  const long long w = e >> 5;
  const int bit = static_cast<int>(e & 31);
  const unsigned word = flag_word(flags, flag_bytes, w);
  set = (word >> bit) & 1u;
  return prefix[w] + __popc(word & ((1u << bit) - 1u));
}

// Hot entry (row, col): -1 past the row's count; else the u8 tier's id
// or the large tier's (u16, or u12 = u8 low | nibble high << 8), every
// index clipped to its plane.
__device__ __forceinline__ int hot_id(const uint8_t* hc, int row, int col,
                                      const int* hot_row_start,
                                      const uint8_t* hf, long long hf_bytes,
                                      const int* hot_prefix,
                                      const uint8_t* h8, int cap8,
                                      const void* hx, int capx, int hx_u16,
                                      const uint8_t* hxh, int caph) {
  if (col >= hc[row]) return -1;
  const long long cap_bits = hf_bytes * 8;
  if (cap_bits == 0) return 0;
  long long e = static_cast<long long>(hot_row_start[row]) + col;
  if (e > cap_bits - 1) e = cap_bits - 1;
  bool small;
  const int rank = flag_rank(hf, hf_bytes, hot_prefix, e, small);
  if (small) return cap8 > 0 ? h8[min(rank, cap8 - 1)] : 0;
  if (capx == 0) return 0;
  const long long r0 = e - rank;
  const int r = static_cast<int>(r0 < capx - 1 ? r0 : capx - 1);
  if (hx_u16) return static_cast<const uint16_t*>(hx)[r];
  int id = static_cast<const uint8_t*>(hx)[r];
  if (r / 2 < caph) id |= ((hxh[r / 2] >> (4 * (r & 1))) & 0xF) << 8;
  return id;
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ cc, int b, int k,
              const int* __restrict__ row_start,
              const uint8_t* __restrict__ cf, long long cf_bytes,
              const int* __restrict__ word_prefix,
              const uint16_t* __restrict__ ci, int cap_i,
              const uint8_t* __restrict__ cu, int cap_d,
              const uint8_t* __restrict__ ct, int cap_t, int key_bytes,
              const uint8_t* __restrict__ lb, const uint8_t* __restrict__ wb,
              int* __restrict__ ckeys, uint8_t* __restrict__ labels,
              uint8_t* __restrict__ weights, int kh,
              const uint8_t* __restrict__ hc,
              const int* __restrict__ hot_row_start,
              const uint8_t* __restrict__ hf, long long hf_bytes,
              const int* __restrict__ hot_prefix,
              const uint8_t* __restrict__ h8, int cap8,
              const void* __restrict__ hx, int capx, int hx_u16,
              const uint8_t* __restrict__ hxh, int caph,
              int* __restrict__ hot) {
  const long long total = static_cast<long long>(b) * k;
  const long long hot_total = static_cast<long long>(b) * kh;
  long long n = total > b ? total : b;
  if (hot_total > n) n = hot_total;
  const long long cap_bits = cf_bytes * 8;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    if (i < total) {
      const int row = static_cast<int>(i / k);
      const int col = static_cast<int>(i - static_cast<long long>(row) * k);
      int key = -1;
      if (col < cc[row]) {
        key = 0;
        if (cap_bits > 0) {
          long long e = static_cast<long long>(row_start[row]) + col;
          if (e > cap_bits - 1) e = cap_bits - 1;
          bool in_dict;
          const int rank = flag_rank(cf, cf_bytes, word_prefix, e, in_dict);
          if (in_dict) {
            const int idx = cap_i > 0 ? ci[min(rank, cap_i - 1)] : 0;
            if (cap_d > 0) key = read_key(cu, min(idx, cap_d - 1), key_bytes);
          } else if (cap_t > 0) {
            const long long r = e - rank;
            key = read_key(ct, static_cast<int>(r < cap_t - 1 ? r : cap_t - 1),
                           key_bytes);
          }
        }
      }
      ckeys[i] = key;
    }
    if (i < hot_total) {
      const int row = static_cast<int>(i / kh);
      const int col = static_cast<int>(i - static_cast<long long>(row) * kh);
      hot[i] = hot_id(hc, row, col, hot_row_start, hf, hf_bytes, hot_prefix,
                      h8, cap8, hx, capx, hx_u16, hxh, caph);
    }
    if (i < b) {
      labels[i] = (lb[i >> 3] >> (i & 7)) & 1;
      weights[i] = (wb[i >> 3] >> (i & 7)) & 1;
    }
  }
}

}  // namespace

// K6 on `stream`: the scan launch, then the decode launch; kh = 0
// means no hot tiers (their pointers unread).  Returns
// cudaGetLastError() after the launches (0 = launched).
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
                              int* hot, void* stream) {
  if (b <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh <= 0) {
    kh = 0;
    hc = nullptr;
  }
  const int n_words = static_cast<int>((cf_bytes + 3) / 4);
  const int n_hwords = static_cast<int>((hf_bytes + 3) / 4);
  scan_kernel<<<1, kScanThreads, 0, s>>>(cc, b, cf, cf_bytes, n_words,
                                         row_start, word_prefix, hc, hf,
                                         hf_bytes, n_hwords, hot_row_start,
                                         hot_prefix);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long total = static_cast<long long>(b) * k;
  long long n = total > b ? total : b;
  const long long hot_total = static_cast<long long>(b) * kh;
  if (hot_total > n) n = hot_total;
  decode_kernel<<<grid_for(n), kThreads, 0, s>>>(
      cc, b, k, row_start, cf, cf_bytes, word_prefix, ci, cap_i, cu, cap_d,
      ct, cap_t, key_bytes, lb, wb, ckeys, labels, weights, kh, hc,
      hot_row_start, hf, hf_bytes, hot_prefix, h8, cap8, hx, capx, hx_u16, hxh,
      caph, hot);
  return static_cast<int>(cudaGetLastError());
}
