// The grid of the port's grid-stride elementwise kernels (tsdiv.cu,
// ilm.cu): enough blocks to give each thread `per_thread` items in one
// pass, at most as many as the current device holds resident at once, so
// a block's set-up (tsdiv's staged seed table) is paid once per resident
// block.
#pragma once

#include <cuda_runtime.h>

template <class Kernel>
cudaError_t grid_stride_blocks(Kernel kernel, int threads, int per_thread, long long n,
                               unsigned int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const long long per_block = (long long)per_thread * threads;
  const long long want = (n + per_block - 1) / per_block;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (unsigned int)(want < 1 ? 1 : (want < most ? want : most));
  return cudaSuccess;
}
