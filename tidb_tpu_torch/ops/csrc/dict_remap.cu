// K13 dict_remap: the composite join key of one side, in its shared domain.
//
// Replaces tidb_tpu/ops/kernels.py:1877 dict_remap_keys, the device half of
// the dictionary key tier (tidb_tpu_torch/copr/dictionary.py lowers each
// key column of a string or multi-column equi-join to a KeySpec). Per
// column the row's code is
//   codes      : the value clipped to [0, cmax];
//   remap      : the table entry at the value clipped to the table (0 for
//                an empty table), clipped to [0, cmax];
//   domain i64 : the lower bound of the value among the sorted table,
//                clipped to [0, cmax];
//   domain f64 : the same over order words (domain_word): every NaN made
//                the one positive NaN, -0.0 made +0.0, the bits mapped to
//                two's complement (common.cuh key_word), so NaN sorts after
//                +inf and takes the NaN entry's code as numpy's and the
//                reference's searches give it;
// the key is the sum of code * stride (mixed radix, int64), and the row is
// valid when every column's valid byte is. The search stops at the table's
// length, so the table needs no padding (the reference pads it to a
// bucket with a +sentinel).
//
// Bound by bytes: per row and column the value (8 B) and valid byte read;
// per row the key (8 B) and valid byte written. What the design does
// about it:
// - The columns ride by value in the kernel's parameter block (K13Params,
//   packed by ops/kernels.py k13_plan): no descriptor is copied to the
//   card before a launch, and the row loop reads none from memory. The
//   kernel is not specialised on its columns' modes: the mode switch is
//   uniform across the block and taken once a (tile, column) step of
//   K13_ROWS rows a thread, outside the rows (k12_k13_variants.py's
//   modes_fixed times the loop with the switch fixed at one mode).
// - A domain row first takes an interpolation probe (k13_search): in a
//   dense domain (surrogate keys 1..n, as f2's l_partkey and l_suppkey)
//   two neighbouring loads settle it. A random search over a table, even
//   one in shared memory, is bank conflicts and dependent steps: f2's
//   searches alone took 0.45 ms of 0.57.
// - The rows the probe leaves search the table: staged whole in shared
//   memory where it fits (as domain words for f64), else a sample of every
//   2^s-th word and one slice of the table in L2 (sample_search.cuh,
//   shared with K12). Whole waves of blocks stride over the row tiles, so
//   the staging is paid once a block.
// - K13_ROWS rows a thread, K13_THREADS apart, so each load of the value
//   and valid planes is coalesced across the warp and the rows' searches
//   step together.
// More than K13_MAX_COLS columns take a launch per group, each after the
// first adding to the key and valid planes the one before wrote.
#include "sample_search.cuh"

#define K13_THREADS 512
#define K13_MIN_BLOCKS 1         // blocks an SM the registers leave room for
#define K13_ROWS 4
#define K13_MAX_COLS 16
#define K13_SMEM (110 * 1024)    // shared memory for tables and samples
#define K13_SAMPLE 8192          // sample entries at most a column
#define K13_WORDS 11             // int64 words of a packed column

enum K13Mode { K13_CODES = 0, K13_REMAP = 1, K13_DOM_I64 = 2, K13_DOM_F64 = 3 };

struct K13Col {
  const i64* vals;
  const unsigned char* valid;
  const i64* table;
  i64 tlen, cmax, stride;
  i64 ns;                          // staged entries (0: the table is read in L2)
  i64 soff;                        // their first word in shared memory
  int mode, shift, sbits, pad;
};

struct K13Params {
  i64 n;
  int ncols, accumulate;
  K13Col col[K13_MAX_COLS];
};

__device__ __forceinline__ i64 k13_clip(i64 v, i64 hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The order word of an f64 domain value: NaN as the one positive NaN.
struct DomainWord {
  __device__ __forceinline__ i64 operator()(i64 bits) const {
    return key_word(as_f64(bits) != as_f64(bits) ? 0x7ff8000000000000ll : bits, 1);
  }
};

// The codes of a thread's rows for one column: lower bounds of the rows'
// words in the table (staged whole, sampled, or read in L2).
//
// First an interpolation probe: a word at or below the
// table's first takes 0, one above its last the table's length; else the
// row guesses its place g from where its word lies between the first and
// the last, and the bound is g when words g - 1 and g hold it between
// them. A dense domain (surrogate keys 1..n, the usual join key) settles
// every row so, with two loads next to each other; the rows whose guess
// missed take the sample search, which a warp skips when none of its rows
// needs it.
template <class Word>
__device__ __forceinline__ void k13_search(const K13Col& c, const i64* smem,
                                           const i64 (&v)[K13_ROWS], const bool (&on)[K13_ROWS],
                                           i64 (&code)[K13_ROWS], Word word) {
  i64 key[K13_ROWS], b0[K13_ROWS], b1[K13_ROWS];
  bool need[K13_ROWS];
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) {
    key[r] = word(v[r]);
    b0[r] = 0;
    b1[r] = c.tlen;
    need[r] = on[r];
  }
  if (c.tlen == 0) {
#pragma unroll
    for (int r = 0; r < K13_ROWS; ++r) code[r] = 0;
    return;
  }
  // the table staged whole: its words in shared memory
  const i64* whole = c.ns > 0 && c.shift == 0 ? smem + c.soff : nullptr;
  const i64 first = whole ? whole[0] : word(c.table[0]);
  const i64 last = whole ? whole[c.tlen - 1] : word(c.table[c.tlen - 1]);
  const double scale = last > first ? (double)(c.tlen - 1) / ((double)last - (double)first) : 0.0;
  i64 g[K13_ROWS], lo[K13_ROWS], hi[K13_ROWS];
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) {
    const i64 q = llrint(((double)key[r] - (double)first) * scale);
    g[r] = q < 1 ? 1 : (q > c.tlen - 1 ? c.tlen - 1 : q);
  }
  const bool mid = c.tlen > 1;
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) {
    const bool probe = mid && key[r] > first && key[r] <= last;
    lo[r] = probe ? (whole ? whole[g[r] - 1] : word(c.table[g[r] - 1])) : 0;
    hi[r] = probe ? (whole ? whole[g[r]] : word(c.table[g[r]])) : 0;
  }
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) {
    if (key[r] <= first) {
      code[r] = 0;
      need[r] = false;
    } else if (key[r] > last) {
      code[r] = c.tlen;
      need[r] = false;
    } else if (lo[r] < key[r] && key[r] <= hi[r]) {
      code[r] = g[r];
      need[r] = false;
    }
  }
  bool any = false;
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) any |= need[r];
  if (!__any_sync(0xffffffffu, any)) return;
  i64 got[K13_ROWS];
  if (c.ns > 0)
    sampled_lower<K13_ROWS, false>(c.table, smem + c.soff, c.shift, c.sbits, b0, b1, key, need,
                                   got, word);
  else
    lifted_lower(c.table, c.tlen, c.sbits, key, got, word);   // the table in L2
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r)
    if (need[r]) code[r] = got[r];
}

// The values and valid bytes of K13_ROWS rows from base, K13_THREADS
// apart (each load coalesced across the warp; indices clamped into the
// planes).
__device__ __forceinline__ void k13_load(const K13Col& d, i64 base, i64 n, i64 (&v)[K13_ROWS],
                                         unsigned char (&vb)[K13_ROWS]) {
#pragma unroll
  for (int r = 0; r < K13_ROWS; ++r) {
    const i64 i = base + (i64)r * K13_THREADS;
    const i64 x = i < n ? i : n - 1;
    v[r] = d.vals[x];
    vb[r] = d.valid[x];
  }
}

__global__ void __launch_bounds__(K13_THREADS, K13_MIN_BLOCKS)
k13_remap(const __grid_constant__ K13Params a, i64* __restrict__ key_out,
          unsigned char* __restrict__ valid_out) {
  extern __shared__ i64 k13_smem[];
  for (int c = 0; c < a.ncols; ++c) {
    const K13Col& d = a.col[c];
    if (d.ns == 0) continue;
    const int ns = (int)d.ns;
    if (d.mode == K13_DOM_F64)
      stage_sample(d.table, d.shift, ns, ns, k13_smem + d.soff, DomainWord());
    else
      stage_sample(d.table, d.shift, ns, ns, k13_smem + d.soff, WordAsIs());
  }
  __syncthreads();
  const i64 tile_rows = (i64)K13_THREADS * K13_ROWS;
  const i64 ntiles = (a.n + tile_rows - 1) / tile_rows;
  // the (tile, column) steps in order, each step's values and valid bytes
  // loaded one step ahead, so they are in flight while the step before
  // searches
  i64 v[K13_ROWS];
  unsigned char vb[K13_ROWS];
  if (blockIdx.x < ntiles)
    k13_load(a.col[0], (i64)blockIdx.x * tile_rows + threadIdx.x, a.n, v, vb);
  for (i64 tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const i64 base = tile * tile_rows + threadIdx.x;
    bool in[K13_ROWS], ok[K13_ROWS];
    u64 k[K13_ROWS];
#pragma unroll
    for (int r = 0; r < K13_ROWS; ++r) {
      const i64 i = base + (i64)r * K13_THREADS;
      in[r] = i < a.n;
      k[r] = 0;
      ok[r] = in[r];
      if (a.accumulate && in[r]) {
        k[r] = (u64)key_out[i];
        ok[r] = valid_out[i] != 0;
      }
    }
#pragma unroll 1
    for (int c = 0; c < a.ncols; ++c) {
      const K13Col& d = a.col[c];
      i64 vn[K13_ROWS], code[K13_ROWS];
      unsigned char vbn[K13_ROWS];
      const bool more = c + 1 < a.ncols;
      const i64 tn = more ? tile : tile + gridDim.x;
      if (tn < ntiles) k13_load(a.col[more ? c + 1 : 0], tn * tile_rows + threadIdx.x, a.n, vn, vbn);
#pragma unroll
      for (int r = 0; r < K13_ROWS; ++r) ok[r] = ok[r] && vb[r] != 0;
      switch (d.mode) {
        case K13_CODES:
#pragma unroll
          for (int r = 0; r < K13_ROWS; ++r) code[r] = k13_clip(v[r], d.cmax);
          break;
        case K13_REMAP:
#pragma unroll
          for (int r = 0; r < K13_ROWS; ++r) code[r] = 0;
          if (d.tlen > 0) {
#pragma unroll
            for (int r = 0; r < K13_ROWS; ++r) {
              const i64 x = k13_clip(v[r], d.tlen - 1);
              code[r] = d.ns > 0 ? k13_smem[d.soff + x] : d.table[x];
            }
#pragma unroll
            for (int r = 0; r < K13_ROWS; ++r) code[r] = k13_clip(code[r], d.cmax);
          }
          break;
        case K13_DOM_I64:
          k13_search(d, k13_smem, v, in, code, WordAsIs());
#pragma unroll
          for (int r = 0; r < K13_ROWS; ++r) code[r] = k13_clip(code[r], d.cmax);
          break;
        default:
          k13_search(d, k13_smem, v, in, code, DomainWord());
#pragma unroll
          for (int r = 0; r < K13_ROWS; ++r) code[r] = k13_clip(code[r], d.cmax);
          break;
      }
#pragma unroll
      for (int r = 0; r < K13_ROWS; ++r) k[r] += (u64)code[r] * (u64)d.stride;
#pragma unroll
      for (int r = 0; r < K13_ROWS; ++r) {
        v[r] = vn[r];
        vb[r] = vbn[r];
      }
    }
#pragma unroll
    for (int r = 0; r < K13_ROWS; ++r) {
      const i64 i = base + (i64)r * K13_THREADS;
      if (in[r]) {
        key_out[i] = (i64)k[r];
        valid_out[i] = ok[r];
      }
    }
  }
}

// The kernel's constants for the host's plan (ops/kernels.py k13_plan):
// out = [K13_MAX_COLS, K13_SMEM, K13_SAMPLE, K13_WORDS].
extern "C" int dict_remap_config(i64* out) {
  out[0] = K13_MAX_COLS;
  out[1] = K13_SMEM;
  out[2] = K13_SAMPLE;
  out[3] = K13_WORDS;
  return 0;
}

// One launch over n rows: words, host memory, holds ncols packed columns
// of K13_WORDS int64 (mode, values, valid, table, table length, cmax,
// stride, shift, staged entries, their first word in shared memory, the
// search's steps over the sample); smem the bytes they stage. With
// accumulate the launch adds to key and valid as an earlier one left them.
extern "C" int dict_remap_launch(i64 n, int ncols, const i64* words, i64 smem, int accumulate,
                                 i64* key, unsigned char* valid, void* stream) {
  if (n < 1 || ncols < 1 || ncols > K13_MAX_COLS || smem < 0 || smem > K13_SMEM) return -1;
  K13Params a;
  a.n = n;
  a.ncols = ncols;
  a.accumulate = accumulate;
  for (int c = 0; c < K13_MAX_COLS; ++c) {
    K13Col& d = a.col[c];
    const i64* w = words + (i64)K13_WORDS * (c < ncols ? c : 0);
    d.mode = (int)w[0];
    d.vals = (const i64*)w[1];
    d.valid = (const unsigned char*)w[2];
    d.table = (const i64*)w[3];
    d.tlen = w[4];
    d.cmax = w[5];
    d.stride = w[6];
    d.shift = (int)w[7];
    d.ns = w[8];
    d.soff = w[9];
    d.sbits = (int)w[10];
    d.pad = 0;
    if (c < ncols && (d.mode < K13_CODES || d.mode > K13_DOM_F64 || d.tlen < 0 || d.ns < 0
                      || 8 * (d.soff + d.ns) > smem))
      return -1;
  }
  // per device: the opt-in, and the grid of whole waves at the last size
  static bool ready[64];
  static i64 at[64];
  static int waves[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(k13_remap, cudaFuncAttributeMaxDynamicSharedMemorySize, K13_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  if (waves[dev] == 0 || at[dev] != smem) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k13_remap, K13_THREADS,
                                                        (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    waves[dev] = (occ > 0 ? occ : 1) * sms;
    at[dev] = smem;
  }
  const i64 ntiles = (n + (i64)K13_THREADS * K13_ROWS - 1) / ((i64)K13_THREADS * K13_ROWS);
  const i64 grid = ntiles < waves[dev] ? ntiles : waves[dev];
  k13_remap<<<(unsigned)grid, K13_THREADS, (size_t)smem, (cudaStream_t)stream>>>(a, key, valid);
  return (int)cudaGetLastError();
}
