// The threshold-filter selection of K10 (topk_select.cu) and K20
// (shard_topk.cu): composite keys in registers and shared memory, a
// persistent level-1 grid over the rows, merge levels over the blocks'
// lists, rounds past the largest K a block holds. K10 runs it over one
// run of n rows; K20 over S shards of L rows, each level's blocks split
// evenly over the shards, so no list mixes two shards and the last level
// is one block a shard. The design and what bounds it are in
// topk_select.cu's note.
#pragma once

#include <cstring>

#include "topk.cuh"

#define K10_THREADS 512
#define K10_ROWS 2
#define K10_MINB 2      // resident blocks a launch bound asks for
#define K10_STEP (K10_THREADS * K10_ROWS)
#define K10_MAXK 4
#define K10_MAX_SLOTS 8192
#define K10_SMEM_LIMIT 231424   // dynamic shared memory: 227 KB less 1 KB static
#define K10_MERGE_ENTRIES 32768

// One ORDER BY item, passed by value (kernels.K10Key mirrors this layout).
struct K10Key {
  const i64* values;
  const unsigned char* valid;
  i64 is_f64;
  i64 desc;
};

// A level's lists in device memory: `cap` entries, structure of arrays
// (words [nk][cap], then flags [cap], rows [cap], then a count per list).
struct K10List {
  u64* word;
  unsigned* flag;
  unsigned* row;
  int* count;
};

__host__ __device__ inline K10List k10_list(void* base, i64 cap, int nk) {
  K10List l;
  char* p = (char*)base;
  l.word = (u64*)p;
  l.flag = (unsigned*)(p + 8 * cap * nk);
  l.row = l.flag + cap;
  l.count = (int*)(l.row + cap);
  return l;
}

struct K10Args {
  i64 n;                          // level 1: rows (of every shard)
  const unsigned char* mask;
  K10Key key[K10_MAXK];
  K10List in;                     // level > 1: the previous level's lists
  int in_lists, fan_in;
  K10List out;                    // lists of this level (not the last)
  K10List bound;                  // one entry a shard: the previous round's last key
  int K, slots, has_lb, final_level, count_live, live_blocks;
  i64* idx;                       // the last level: rows to idx[s * kk + idx_off ...]
  i64 idx_off, kk;
  i64* live_part;                 // live rows per level-1 block (round 0)
  i64* n_live;                    // [shards]
  // K20: the rows are `shards` shards of L rows each (K10: one of n); a
  // level's blocks split evenly over the shards and never mix two; the
  // last level (a block a shard) writes shard-local rows and, where
  // `words` is set, each key's order word and null rank [shards, nk, kk]
  i64 L;
  int shards;
  i64* words;
  unsigned char* nulls;
};

template <int NK>
struct K10Ent {
  unsigned f;     // bit 7 dead, bit j key j's null rank
  unsigned row;
  u64 w[NK > 0 ? NK : 1];
};

// does a come before b?
template <int NK>
__device__ __forceinline__ bool k10_less(const K10Ent<NK>& a, const K10Ent<NK>& b) {
  const unsigned da = a.f & TOPK_DEAD, db = b.f & TOPK_DEAD;
  if (da != db) return da < db;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const unsigned na = (a.f >> j) & 1u, nb = (b.f >> j) & 1u;
    if (na != nb) return na < nb;
    if (a.w[j] != b.w[j]) return a.w[j] < b.w[j];
  }
  return a.row < b.row;
}

// A row's planes as loaded (bit 0 of f: live; bit 1 + j: key j valid; the
// values' bits in w), so that a step's loads are all in flight at once.
template <int NK>
__device__ __forceinline__ void k10_fetch(const K10Args& a, i64 row, K10Ent<NK>& e) {
  unsigned f = a.mask[row] != 0;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const K10Key& kd = a.key[j];
    f |= (unsigned)(kd.valid == nullptr || kd.valid[row] != 0) << (1 + j);
    e.w[j] = (u64)kd.values[row];
  }
  e.f = f;
  e.row = (unsigned)row;
}

// The fetched row's composite key: the dead bit and each key's null rank
// in the flags, each key's order word.
template <int NK>
__device__ __forceinline__ void k10_encode(const K10Args& a, K10Ent<NK>& e) {
  unsigned f = (e.f & 1u) ? 0u : TOPK_DEAD;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const bool valid = (e.f >> (1 + j)) & 1u;
    const bool desc = a.key[j].desc != 0;
    u64 w = 0;
    if (valid) {
      i64 x = (i64)e.w[j];
      if (a.key[j].is_f64) {
        if (as_f64(x) == 0.0) x = 0;
        if (x < 0) x ^= I64_MAX_V;
      }
      w = (u64)x ^ 0x8000000000000000ull;
      if (desc) w = ~w;
    }
    f |= (unsigned)(desc ? !valid : valid) << j;
    e.w[j] = w;
  }
  e.f = f;
}

template <int NK>
__device__ __forceinline__ K10Ent<NK> k10_load(const K10List& l, i64 cap, i64 i) {
  K10Ent<NK> e;
  e.f = l.flag[i];
  e.row = l.row[i];
#pragma unroll
  for (int j = 0; j < NK; ++j) e.w[j] = l.word[(i64)j * cap + i];
  return e;
}

template <int NK>
__device__ __forceinline__ void k10_store(const K10List& l, i64 cap, i64 i,
                                          const K10Ent<NK>& e) {
  l.flag[i] = e.f;
  l.row[i] = e.row;
#pragma unroll
  for (int j = 0; j < NK; ++j) l.word[(i64)j * cap + i] = e.w[j];
}

#define K10_NONE 0xffffu

// A block's shared memory: P slots of keys (structure of arrays) that
// never move, and four lists of 16-bit slot numbers: ord (the kept keys,
// sorted), fl (the free slots; new candidates take fl[0], fl[1], ...),
// app and mrg (the flush's scratch).
template <int NK>
struct K10Slots {
  u64* w;
  unsigned* f;
  unsigned* r;
  unsigned short *ord, *fl, *app, *mrg;
  int P;
  __device__ __forceinline__ K10Ent<NK> get(int i) const {
    K10Ent<NK> e;
    e.f = f[i];
    e.row = r[i];
#pragma unroll
    for (int j = 0; j < NK; ++j) e.w[j] = w[j * P + i];
    return e;
  }
  __device__ __forceinline__ void put(int i, const K10Ent<NK>& e) const {
    f[i] = e.f;
    r[i] = e.row;
#pragma unroll
    for (int j = 0; j < NK; ++j) w[j * P + i] = e.w[j];
  }
  // does slot a come before slot b (K10_NONE after every slot)? Fields
  // are read as the comparison needs them.
  __device__ __forceinline__ bool less(unsigned a, unsigned b) const {
    if (a == K10_NONE) return false;
    if (b == K10_NONE) return true;
    const unsigned fa = f[a], fb = f[b];
    const unsigned da = fa & TOPK_DEAD, db = fb & TOPK_DEAD;
    if (da != db) return da < db;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const unsigned na = (fa >> j) & 1u, nb = (fb >> j) & 1u;
      if (na != nb) return na < nb;
      const u64 wa = w[j * P + a], wb = w[j * P + b];
      if (wa != wb) return wa < wb;
    }
    return r[a] < r[b];
  }
};

// The merge path of ord[0, kc) and app[0, cnt) (both sorted): how many of
// the first d merged keys come from ord.
template <int NK>
__device__ __forceinline__ int k10_corank(const K10Slots<NK>& s, int kc, int cnt, int d) {
  int lo = d - cnt > 0 ? d - cnt : 0, hi = d < kc ? d : kc;
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (s.less(s.ord[i], s.app[d - i - 1])) lo = i + 1; else hi = i;
  }
  return lo;
}

// Fold the cnt new candidates (slots fl[0, cnt)) into the kept list: sort
// their slot numbers (bitonic, keys read from shared memory; skipped when
// they are `sorted` already), merge them
// with ord (each thread a run of the first K merged keys from its
// merge-path split) and keep the first K; the rest and the unused free
// slots become the free list. Every thread calls it and gets the
// threshold (the K-th key) once K keys are kept.
template <int NK>
__device__ void k10_flush(K10Slots<NK>& s, int* s_cnt, int* s_kc, int K, K10Ent<NK>& thr,
                          bool& has_thr, bool sorted = false) {
  __syncthreads();
  const int cnt = *s_cnt, kc = *s_kc, t = threadIdx.x;
  int P2 = 1;
  while (P2 < cnt) P2 <<= 1;
  for (int i = t; i < P2; i += K10_THREADS) s.app[i] = i < cnt ? s.fl[i] : K10_NONE;
  __syncthreads();
  if (sorted) P2 = 1;     // the candidates came in order: merge only
  for (int size = 2; size <= P2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = t; q < P2 / 2; q += K10_THREADS) {
        const int i = 2 * q - (q & (stride - 1));
        const int j = i + stride;
        const unsigned x = s.app[i], y = s.app[j];
        if (s.less(y, x) == ((i & size) == 0)) {
          s.app[i] = (unsigned short)y;
          s.app[j] = (unsigned short)x;
        }
      }
      __syncthreads();
    }
  }
  const int kn = kc + cnt < K ? kc + cnt : K, spill = kc + cnt - kn;
  const int per = (kn + K10_THREADS - 1) / K10_THREADS;
  const int d0 = t * per < kn ? t * per : kn, d1 = d0 + per < kn ? d0 + per : kn;
  if (d0 < d1) {
    int i = k10_corank(s, kc, cnt, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d)
      s.mrg[d] = (j >= cnt || (i < kc && s.less(s.ord[i], s.app[j]))) ? s.ord[i++] : s.app[j++];
  }
  // the keys past the first kn: ord[ia, kc) and app[jb, cnt)
  const int ia = k10_corank(s, kc, cnt, kn), jb = kn - ia;
  for (int q = t; q < spill; q += K10_THREADS)
    s.mrg[kn + q] = q < kc - ia ? s.ord[ia + q] : s.app[jb + q - (kc - ia)];
  __syncthreads();
  for (int q = t; q < spill; q += K10_THREADS) s.app[q] = s.mrg[kn + q];
  for (int q = t; q < s.P - kc - cnt; q += K10_THREADS) s.app[spill + q] = s.fl[cnt + q];
  __syncthreads();
  unsigned short* tmp = s.fl;     // the new free list
  s.fl = s.app;
  s.app = tmp;
  tmp = s.ord;                    // the new kept list
  s.ord = s.mrg;
  s.mrg = tmp;
  has_thr = kn == K;
  if (has_thr) thr = s.get(s.ord[K - 1]);
  __syncthreads();
  if (t == 0) {
    *s_cnt = 0;
    *s_kc = kn;
  }
  __syncthreads();
}

// Every lane of the warp calls it; lanes with `take` append `e` to the
// next free slots.
template <int NK>
__device__ __forceinline__ void k10_push(const K10Slots<NK>& s, int* s_cnt, bool take,
                                         const K10Ent<NK>& e) {
  const unsigned bal = __ballot_sync(0xffffffffu, take);
  if (bal == 0u) return;
  const int lane = threadIdx.x & 31, leader = __ffs((int)bal) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(s_cnt, __popc(bal));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) s.put(s.fl[base + __popc(bal & ((1u << lane) - 1u))], e);
}

template <int NK, bool L1>
__global__ void __launch_bounds__(K10_THREADS, K10_MINB) k10_level(const __grid_constant__ K10Args a) {
  extern __shared__ u64 k10_smem[];
  __shared__ int s_cnt, s_kc, s_snap;
  __shared__ i64 s_live[K10_THREADS / 32];
  const int t = threadIdx.x;
  const int P = a.slots;
  K10Slots<NK> s;
  s.w = k10_smem;
  s.f = (unsigned*)(k10_smem + (size_t)NK * P);
  s.r = s.f + P;
  s.ord = (unsigned short*)(s.r + P);
  s.fl = s.ord + P;
  s.app = s.fl + P;
  s.mrg = s.app + P;
  s.P = P;
  for (int i = t; i < P; i += K10_THREADS) s.fl[i] = (unsigned short)i;
  if (t == 0) {
    s_cnt = 0;
    s_kc = 0;
  }
  // this block's shard and its place among the shard's blocks
  const int per = gridDim.x / a.shards;
  const int sh = blockIdx.x / per, jb = blockIdx.x - sh * per;
  K10Ent<NK> thr, lb;
  bool has_thr = false;
  const bool has_lb = L1 && a.has_lb;
  if (has_lb) lb = k10_load<NK>(a.bound, a.shards, sh);
  i64 live = 0;
  __syncthreads();

  // the block's inputs: a slice of its shard's rows, or fan_in of its
  // shard's lists of K entries
  i64 lo, hi;
  if (L1) {
    lo = (i64)sh * a.L + a.L * jb / per;
    hi = (i64)sh * a.L + a.L * (jb + 1) / per;
  } else {
    const int per_in = a.in_lists / a.shards;
    const i64 l0 = (i64)sh * per_in + (i64)jb * a.fan_in;
    const i64 le = (i64)(sh + 1) * per_in;
    const i64 l1 = l0 + a.fan_in < le ? l0 + a.fan_in : le;
    lo = l0 * a.K;
    hi = l1 * a.K;
  }
  const i64 in_cap = (i64)a.in_lists * a.K;
  auto fetch = [&](i64 i, K10Ent<NK>& e) -> bool {
    if (i >= hi) return false;
    if (L1) {
      k10_fetch<NK>(a, i, e);
      return true;
    }
    const i64 l = i / a.K;
    if (i - l * a.K >= a.in.count[l]) return false;
    e = k10_load<NK>(a.in, in_cap, i);
    return true;
  };
  auto fetch_step = [&](i64 base, K10Ent<NK> (&e)[K10_ROWS], bool (&in)[K10_ROWS]) {
#pragma unroll
    for (int u = 0; u < K10_ROWS; ++u) in[u] = fetch(base + u * K10_THREADS + t, e[u]);
  };
  // flush when the buffer could overflow, and as soon as K keys are seen
  // (the first threshold)
  auto run_step = [&](K10Ent<NK> (&e)[K10_ROWS], const bool (&in)[K10_ROWS]) {
    if (t == 0) s_snap = s_cnt + s_kc;
    __syncthreads();
    if (s_snap + K10_STEP > P || (!has_thr && s_snap >= a.K))
      k10_flush<NK>(s, &s_cnt, &s_kc, a.K, thr, has_thr);
#pragma unroll
    for (int u = 0; u < K10_ROWS; ++u) {
      if (L1 && in[u]) {
        k10_encode<NK>(a, e[u]);
        live += (e[u].f & TOPK_DEAD) == 0u;
      }
      const bool take = in[u] && (!has_lb || k10_less(lb, e[u])) &&
                        (!has_thr || k10_less(e[u], thr));
      k10_push<NK>(s, &s_cnt, take, e[u]);
    }
    __syncthreads();
  };
  if (!L1 && a.K >= K10_STEP) {
    // long sorted lists: list by list, a chunk of K10_STEP entries at a
    // time; those before the threshold are a prefix of the chunk, placed in
    // order and merged without a sort; the first that fails ends the list
    for (i64 l = lo / a.K; l < hi / a.K; ++l) {
      const int len = a.in.count[l];
      for (int j0 = 0; j0 < len; j0 += K10_STEP) {
        bool tk[K10_ROWS];
        K10Ent<NK> e[K10_ROWS];
        int n_take = 0;
#pragma unroll
        for (int u = 0; u < K10_ROWS; ++u) {
          const int j = j0 + u * K10_THREADS + t;
          tk[u] = j < len;
          if (tk[u]) {
            e[u] = k10_load<NK>(a.in, in_cap, l * a.K + j);
            tk[u] = !has_thr || k10_less(e[u], thr);
          }
          n_take += __syncthreads_count(tk[u]);
        }
#pragma unroll
        for (int u = 0; u < K10_ROWS; ++u)
          if (tk[u]) s.put(s.fl[u * K10_THREADS + t], e[u]);
        if (t == 0) s_cnt = n_take;
        if (n_take > 0) k10_flush<NK>(s, &s_cnt, &s_kc, a.K, thr, has_thr, true);
        if (n_take < K10_STEP) break;
      }
    }
  } else {
  // two sets of registers: a step's loads are in flight while the step
  // before it runs
  K10Ent<NK> ea[K10_ROWS], eb[K10_ROWS];
  bool ia[K10_ROWS], ib[K10_ROWS];
  fetch_step(lo, ea, ia);
  for (i64 base = lo; base < hi; base += 2 * K10_STEP) {
    fetch_step(base + K10_STEP, eb, ib);
    run_step(ea, ia);
    if (base + K10_STEP < hi) {
      fetch_step(base + 2 * K10_STEP, ea, ia);
      run_step(eb, ib);
    }
  }
  }
  k10_flush<NK>(s, &s_cnt, &s_kc, a.K, thr, has_thr);
  const int keep = s_kc;

  if (L1 && a.count_live) {
    for (int off = 16; off > 0; off >>= 1) live += __shfl_down_sync(0xffffffffu, live, off);
    if ((t & 31) == 0) s_live[t >> 5] = live;
    __syncthreads();
    if (t == 0) {
      i64 tot = 0;
      for (int j = 0; j < K10_THREADS / 32; ++j) tot += s_live[j];
      a.live_part[blockIdx.x] = tot;
    }
  }
  if (!a.final_level) {
    const i64 out_cap = (i64)gridDim.x * a.K;
    for (int j = t; j < keep; j += K10_THREADS)
      k10_store<NK>(a.out, out_cap, (i64)blockIdx.x * a.K + j, s.get(s.ord[j]));
    if (t == 0) a.out.count[blockIdx.x] = keep;
    return;
  }
  // the last level: a block a shard, K keys kept
  const i64 o0 = (i64)sh * a.kk + a.idx_off, rbase = (i64)sh * a.L;
  for (int j = t; j < keep; j += K10_THREADS) {
    const unsigned q = s.ord[j];
    a.idx[o0 + j] = (i64)s.r[q] - rbase;
    if (a.words != nullptr) {
#pragma unroll
      for (int key = 0; key < NK; ++key) {
        const i64 o = ((i64)sh * NK + key) * a.kk + a.idx_off + j;
        a.words[o] = (i64)s.w[key * P + q];
        a.nulls[o] = (unsigned char)((s.f[q] >> key) & 1u);
      }
    }
  }
  if (t == 0 && keep > 0) k10_store<NK>(a.bound, a.shards, sh, s.get(s.ord[keep - 1]));
  if (a.count_live) {
    // the shard's live rows: its level-1 blocks' counts (live_blocks a
    // shard), summed by the block (its own count written above when it
    // is the only level)
    __syncthreads();
    i64 tot = 0;
    const i64* part = a.live_part + (i64)sh * a.live_blocks;
    for (int b = t; b < a.live_blocks; b += K10_THREADS) tot += __ldcg(part + b);
    for (int off = 16; off > 0; off >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, off);
    if ((t & 31) == 0) s_live[t >> 5] = tot;
    __syncthreads();
    if (t == 0) {
      tot = 0;
      for (int j = 0; j < K10_THREADS / 32; ++j) tot += s_live[j];
      a.n_live[sh] = tot < a.kk ? tot : a.kk;
    }
  }
}

// Each instantiation's launch and its shared-memory opt-in (once).
template <int NK, bool L1>
static cudaError_t k10_go(unsigned blocks, size_t smem, cudaStream_t st, const K10Args* a) {
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(k10_level<NK, L1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         K10_SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  if (blocks == 0) return cudaSuccess;
  k10_level<NK, L1><<<blocks, K10_THREADS, smem, st>>>(*a);
  return cudaGetLastError();
}

template <int NK, bool L1>
static cudaError_t k10_occupancy(int* occ, size_t smem) {
  cudaError_t e = k10_go<NK, L1>(0, 0, 0, nullptr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, k10_level<NK, L1>, K10_THREADS, smem);
}

// Launch (blocks > 0) or only prepare (blocks == 0) the level kernel for
// nk keys; with occ, report its resident blocks per SM at smem bytes.
static cudaError_t k10_dispatch(int nk, int level1, unsigned blocks, size_t smem,
                                cudaStream_t st, const K10Args* a, int* occ) {
#define K10_CASE(NK)                                                          \
  case NK:                                                                    \
    if (occ != nullptr)                                                       \
      return level1 ? k10_occupancy<NK, true>(occ, smem)                      \
                    : k10_occupancy<NK, false>(occ, smem);                    \
    return level1 ? k10_go<NK, true>(blocks, smem, st, a)                     \
                  : k10_go<NK, false>(blocks, smem, st, a);
  switch (nk) {
    K10_CASE(0)
    K10_CASE(1)
    K10_CASE(2)
    K10_CASE(3)
    K10_CASE(4)
  }
#undef K10_CASE
  return cudaErrorInvalidValue;
}

// Blocks of the level kernel that fit on the whole card with `slots`
// slots for nk keys (SMs x resident blocks), or minus a CUDA error.
static int k10_grid(int nk, int level1, int slots) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = k10_dispatch(nk, level1, 0, (size_t)slots * (8 * nk + 16), 0, nullptr, &occ);
  if (e != cudaSuccess) return -(int)e;
  return sms * (occ > 0 ? occ : 1);
}

// One level of one round over `shards` shards of L rows (n = shards * L):
// keys: nk K10Key in host memory, copied into the parameter block; in /
// out / bound: list buffers laid out as k10_list with capacities
// in_lists * K, blocks * K and shards. Returns 0, -1 for arguments the
// kernel does not take, or a CUDA error.
static int k10_launch(int nk, int level1, int blocks, int K, int slots, i64 n, i64 L,
                      int shards, const unsigned char* mask, const K10Key* keys, void* in,
                      int in_lists, int fan_in, void* out, void* bound, int has_lb,
                      int final_level, i64* idx, i64* words, unsigned char* nulls, i64 idx_off,
                      i64 kk, i64* live_part, int count_live, int live_blocks, i64* n_live,
                      cudaStream_t st) {
  if (nk < 0 || nk > K10_MAXK || blocks < 1 || K < 1 || slots < K + K10_STEP ||
      slots > K10_MAX_SLOTS || (slots & (slots - 1)) != 0 ||
      (i64)slots * (8 * nk + 16) > K10_SMEM_LIMIT || shards < 1 || L < 0 ||
      n != (i64)shards * L || n > 0xffffffffLL || blocks % shards != 0 ||
      (!level1 && (in_lists < shards || in_lists % shards != 0 || fan_in < 1)) ||
      (final_level && blocks != shards) || (words != nullptr && nulls == nullptr))
    return -1;
  K10Args a;
  memset(&a, 0, sizeof(a));
  a.n = n;
  a.mask = mask;
  if (nk > 0) memcpy(a.key, keys, sizeof(K10Key) * (size_t)nk);
  if (in != nullptr) a.in = k10_list(in, (i64)in_lists * K, nk);
  a.in_lists = in_lists;
  a.fan_in = fan_in;
  if (out != nullptr) a.out = k10_list(out, (i64)blocks * K, nk);
  a.bound = k10_list(bound, shards, nk);
  a.K = K;
  a.slots = slots;
  a.has_lb = has_lb;
  a.final_level = final_level;
  a.count_live = count_live;
  a.live_blocks = live_blocks;
  a.idx = idx;
  a.idx_off = idx_off;
  a.kk = kk;
  a.live_part = live_part;
  a.n_live = n_live;
  a.L = L;
  a.shards = shards;
  a.words = words;
  a.nulls = nulls;
  return (int)k10_dispatch(nk, level1, (unsigned)blocks, (size_t)slots * (8 * nk + 16), st, &a,
                          nullptr);
}
