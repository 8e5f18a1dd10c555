// Deterministic row sums of scattered rows: FUnc-SNE's symmetrisation on
// the unfused force paths (scatter_fused=False with B5, gather_fused=False
// with B7).
//
// Replaces: the `.at[].add` scatters of src/repro/core/funcsne.py:732-738
//   (XLA's scatter-add, not a Pallas kernel), which the port first ran as
//   index_add_: float atomics whose order, and so whose last bits, changed
//   from run to run on the card.
// out[i, :] = sum of val[e, :] over the e with idx[e] == i, added in
//   increasing e -- the order of a sequential index_add_, so the result is
//   the CPU plain version's bit for bit and repeats exactly.
// On those paths it runs once per step over n + n (k_hd + k_ld) rows of d
//   floats (70,000 x 49 rows at MNIST's shape).
//
// Design: the wrapper sorts idx once per call (a stable sort, so each
// row's run keeps increasing e) and finds each row's run by a binary
// search; one thread per (row, column) walks its run in order.  No atomics.
//
// Bound on the H100: bytes.  val is read once (E x d x 4 B), the sorted
// order once (E x 8 B) and out written once; a few flops per element.
#include "common.cuh"

// Mirrored field for field by the ctypes Structure in
// repro_torch/kernels/segment_sum/ops.py.
struct SegmentArgs {
  const float* val;      // (E, d)
  const int64_t* perm;   // (E,) stable order of idx
  const int64_t* offs;   // (n + 1,) run starts of rows 0..n in perm
  float* out;            // (n, d)
  int64_t n;
  int d;
};

namespace {

__global__ void segment_sum_kernel(const SegmentArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n * a.d) return;
  const int64_t row = i / a.d;
  const int c = static_cast<int>(i - row * a.d);
  float acc = 0.f;
  for (int64_t j = a.offs[row]; j < a.offs[row + 1]; ++j)
    acc += a.val[a.perm[j] * a.d + c];
  a.out[i] = acc;
}

}  // namespace

extern "C" int repro_segment_sum(const SegmentArgs* args, cudaStream_t stream) {
  if (args->d < 1 || args->n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = args->n * args->d;
  if (total > 0) {
    segment_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                         stream>>>(*args);
  }
  return static_cast<int>(cudaGetLastError());
}
