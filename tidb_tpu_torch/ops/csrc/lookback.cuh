// The tagged words of the single-pass scans with decoupled look-back
// (K18 window_scan.cu, K19 delta_merge.cu, K12 join_probe.cu; Merrill and
// Garland). A tile publishes each word of its state in a 16-byte record
// {tag, word}, written and read with one 16-byte access, so a word is
// valid exactly when its tag is: no fence orders a status after the
// words. The tag carries the call's epoch (epoch << 2 | kind: 1 the
// tile's aggregate, 2 its inclusive prefix), so a word left by an earlier
// call reads as "not yet" and nothing is reset between calls.
#pragma once

#include "common.cuh"

// A tagged word read from L2 anew each time (volatile: a spin on it sees
// another block's store; one 16-byte access, so the tag and its word
// arrive together).
__device__ __forceinline__ longlong2 ld_tagged(const longlong2* p) {
  longlong2 r;
  asm volatile("ld.volatile.global.v2.s64 {%0, %1}, [%2];\n"
               : "=l"(r.x), "=l"(r.y)
               : "l"(p)
               : "memory");
  return r;
}

// Words [0, W) of a state from lanes [0, W) of a warp, each under `tag`.
__device__ __forceinline__ void put_words(longlong2* rec, int lane, int W, i64 tag, i64 w) {
  if (lane < W) __stcg(rec + lane, make_longlong2(tag, w));
}
