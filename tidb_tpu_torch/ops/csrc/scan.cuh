// Block-wide prefix scans shared by the kernels that count by position
// (K8 rank_groups, K11 join_build): a scan inside each block, one block
// over the block totals, and an add-back by the caller.
// Integer only, no atomics: the result is the same on every run.
#pragma once

#include "common.cuh"

#define SCAN_TOTALS_THREADS 1024

// Inclusive scan of x over the block (blockDim.x a multiple of 32);
// warp_tot is 32 int64 of shared memory.
__device__ __forceinline__ i64 block_scan_incl(i64 x, i64* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const i64 y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    i64 t = lane < nwarps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  const i64 r = x + (warp == 0 ? 0 : warp_tot[warp - 1]);
  __syncthreads();                      // warp_tot is free for the next scan
  return r;
}

// One block of SCAN_TOTALS_THREADS: off[b] = sum of total[0, b) and
// *grand = the sum of all nb totals.
__global__ void __launch_bounds__(SCAN_TOTALS_THREADS)
scan_totals(i64 nb, const i64* __restrict__ total, i64* __restrict__ off,
            i64* __restrict__ grand) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 chunk;
  i64 carry = 0;
  for (i64 b0 = 0; b0 < nb; b0 += blockDim.x) {
    const i64 b = b0 + threadIdx.x;
    const i64 x = b < nb ? total[b] : 0;
    const i64 incl = block_scan_incl(x, warp_tot);
    if (b < nb) off[b] = carry + incl - x;
    if (threadIdx.x == blockDim.x - 1) chunk = incl;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) *grand = carry;
}
