// C interface of the stream-compaction kernel (see compact.cuh for the
// design note). Built by stateright_tpu_torch/ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes by stateright_tpu_torch/ops/compact.py.

#include "compact.cuh"

extern "C" {

// lane_desc holds n_lanes host triples (pointer, s0, s1); see stpu::Lane.
// status: stpu_compact_status_words(m) int64 of scratch. Returns the
// cudaError_t of the launches (0 = cudaSuccess).
int stpu_compact(const void* mask, long long m, long long cols,
                 const long long* lane_desc, int n_lanes, void* out,
                 long long cap, void* status, void* n_valid, void* stream) {
  if (n_lanes < 1 || n_lanes > stpu::kMaxLanes || cols < 1) {
    return (int)cudaErrorInvalidValue;
  }
  stpu::Lanes lanes{};
  lanes.count = n_lanes;
  for (int p = 0; p < n_lanes; ++p) {
    lanes.lane[p].base = reinterpret_cast<const long long*>(lane_desc[3 * p]);
    lanes.lane[p].s0 = lane_desc[3 * p + 1];
    lanes.lane[p].s1 = lane_desc[3 * p + 2];
  }
  return (int)stpu::launch_compact(
      static_cast<const bool*>(mask), m, cols, lanes,
      static_cast<long long*>(out), cap, static_cast<long long*>(status),
      static_cast<long long*>(n_valid), static_cast<cudaStream_t>(stream));
}

long long stpu_compact_status_words(long long m) {
  return stpu::status_words(stpu::num_tiles(m));
}

const char* stpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
