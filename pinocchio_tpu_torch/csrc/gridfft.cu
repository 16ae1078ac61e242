// The dense engine's 3-D transforms: cuFFT plans of the port's own, made
// and called here, on the layouts the hand-written kernels read and write.
//
// Replaces no TPU kernel: the JAX package leaves its transforms to XLA's
// FFT (pinocchio_tpu/backend.py rfft3 and irfft3, the two-step
// decomposition), and cuFFT stays the FFT here.  What this file removes is
// the bookkeeping of PyTorch's cuFFT path around each transform of a
// [c, N, N, N/2+1] spectrum: its copy of the spectrum into a batch-major
// order (the batch dims c and kz do not fold into one stride), the clone of
// every c2r input (cuFFT's c2r overwrites it) and the two normalization
// multiplies, four passes that moved about twice the transforms' own bytes.
//
// The plans (grids.plan_geometry gives every number): the spectrum lies kz
// outermost, [c, N/2+1, N, N], as K2, K5 and K8 write it.  Per component,
// an in-place 2-D c2c over (x, y), each kz plane contiguous (batch N/2+1),
// then one 1-D c2r over z, reading z at stride N^2, out of place into the
// real [c, N, N, N] stack in (x, y, z) order; the forward way one 1-D r2c
// over z into that layout and the same c2c.  (The spectrum's other layout,
// [c, N, N, N/2+1] with the c2c at element stride N/2+1, costs cuFFT 12x
// the contiguous c2c's time at 512^3: PERF.md.)  They are made with
// cufftMakePlanMany64 (element counts past 2^31 plan too), with
// auto-allocation off: the caller hands the work area in from PyTorch's
// allocator at each call, with PyTorch's current stream.  No normalization
// happens here: K2, K5 and K8 fold 1/N^3 into their multiply.
//
// What bounds it on the H100: device memory bytes, cuFFT's own.

#include <cuda_runtime.h>
#include <cufft.h>
#include <stdint.h>

extern "C" int gridfft_plan(int rank, const long long* n,
                            const long long* inembed, long long istride,
                            long long idist, const long long* onembed,
                            long long ostride, long long odist, int type,
                            long long batch, int* handle, size_t* work) {
  cufftHandle h;
  cufftResult r = cufftCreate(&h);
  if (r != CUFFT_SUCCESS) return (int)r;
  r = cufftSetAutoAllocation(h, 0);
  if (r == CUFFT_SUCCESS)
    r = cufftMakePlanMany64(h, rank, const_cast<long long*>(n),
                            const_cast<long long*>(inembed), istride, idist,
                            const_cast<long long*>(onembed), ostride, odist,
                            (cufftType)type, batch, work);
  if (r != CUFFT_SUCCESS) {
    cufftDestroy(h);
    return (int)r;
  }
  *handle = h;
  return 0;
}

// direction: CUFFT_FORWARD (-1) or CUFFT_INVERSE (1), read by C2C alone;
// work may be null where the plan asked for none
extern "C" int gridfft_exec(int handle, int type, int direction, void* in,
                            void* out, void* work, void* stream) {
  cufftResult r = cufftSetStream(handle, (cudaStream_t)stream);
  if (r == CUFFT_SUCCESS && work != nullptr)
    r = cufftSetWorkArea(handle, work);
  if (r != CUFFT_SUCCESS) return (int)r;
  switch ((cufftType)type) {
    case CUFFT_C2C:
      return (int)cufftExecC2C(handle, (cufftComplex*)in,
                               (cufftComplex*)out, direction);
    case CUFFT_C2R:
      return (int)cufftExecC2R(handle, (cufftComplex*)in, (cufftReal*)out);
    case CUFFT_R2C:
      return (int)cufftExecR2C(handle, (cufftReal*)in, (cufftComplex*)out);
    default:
      return (int)CUFFT_INVALID_TYPE;
  }
}
