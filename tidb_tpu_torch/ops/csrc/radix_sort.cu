// The C entry points of the stable radix sort in radix.cuh, which K11
// join_build (ops/kernels.py join_build, join_build_partitioned) and K4
// seg_agg_sorted's sorted route (ops/kernels.py seg_agg_sorted) run one
// planned pass at a time (ops/kernels.py radix_plan, radix_sort_t); see
// radix.cuh for the design.
#include "radix.cuh"

// int32 scratch of one pass over n rows.
extern "C" i64 radix_scratch_ints(i64 n) { return radix_scratch(n); }

// One pass (three launches): keys_in/pay_in (pay_in null: the row
// index) to keys_out/pay_out, stably by the digit at `shift` of the words
// or, with offsets (P + 1 partition starts), of the payload's partition.
extern "C" int radix_pass_launch(i64 n, int shift, const i64* offsets, int P,
                                 const i64* keys_in, const i64* pay_in, i64* keys_out,
                                 i64* pay_out, int* counts, void* stream) {
  return radix_pass(n, shift, offsets, P, keys_in, pay_in, keys_out, pay_out, counts,
                    (cudaStream_t)stream);
}
