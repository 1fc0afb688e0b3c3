// Polyline nearest-distance field on Hopper (sm_90a), batched over traces.
//
// Replaces the Pallas TPU kernel waveform_ot_tpu/ops/pallas_distance.py
// (_kernel, launched by _distance_field_pallas_impl). For every point p of
// each trace's (nu, ntg) grid and every segment (x0, c) of that trace's
// polyline:
//
//     b = p - x0;  lam = clip(b.c / |c|^2, 0, 1);  dsq = |b - lam*c|^2
//
// and it writes d = sqrt(min dsq), the first-tie argmin segment, the winning
// lam and the offset p - x* (interleaved (B, nu, ntg, 2), the JAX layout).
//
// Design.
//  * One thread owns one (trace, grid point): blockIdx.y is the trace,
//    blocks of 256 threads cover the flattened nu*ntg points, and the
//    ragged edge is masked. Nothing is carried between blocks.
//  * The block stages its trace's segment table (x0x, x0y, cx, cy, |c|^2)
//    in shared memory, kTile segments at a time (1024 doubles x 5 = 40 KB,
//    under the 48 KB static limit), and walks the tiles, so any segment
//    count works without the Pallas kernel's far-away dummy padding.
//  * Each thread keeps (min dsq, argmin, lam, dx, dy) in registers; a strict
//    `<` over the ascending segment loop keeps the first minimum, as
//    np.argmin and torch.argmin do.
//  * Arithmetic identical to the plain PyTorch version
//    (waveform_ot_torch.ops.fingerprint.distance_field_torch): point
//    coordinates are read from the tgrid/ugrid tensors rather than
//    synthesized from the index, lam is a true IEEE division, and the file
//    is compiled with -fmad=false so that no mul+add pair is contracted to
//    an FMA (a contraction flips winners at exact geometric ties).
//    -fmad=false is the first lever for a later speed-up, at the price of
//    that bit agreement.
//
// What bounds it on the card. The loc/CMT headline is 192 traces x 4,819
// points x 60 segments = 55M point-segment pairs plus ~26 MB of f32 output
// (8 us of HBM bandwidth). Counted from the source, each pair costs ~35
// instructions, the IEEE division the largest share, so the estimated floor
// is the instruction issue rate, ~60 us on an H100; neither figure has been
// profiled, and the measured times are in PERF.md's kernel table.
// The design keeps it to one launch for the whole batch, reads the segment
// table from shared memory as broadcasts, and writes each output once.
// Instructions per pair are the lever: several points per thread keeps the
// bit agreement; a per-segment reciprocal or FMA gives it up unless the
// plain version changes with them.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
distance_field_kernel(const T* __restrict__ verts, const T* __restrict__ tgrid,
                      const T* __restrict__ ugrid, T* __restrict__ d,
                      int32_t* __restrict__ iclose, T* __restrict__ lam,
                      T* __restrict__ dvec, int nt, int ntg, int nu) {
  __shared__ T s_x0x[kTile];
  __shared__ T s_x0y[kTile];
  __shared__ T s_cx[kTile];
  __shared__ T s_cy[kTile];
  __shared__ T s_lsq[kTile];

  const int b = blockIdx.y;
  const int npts = nu * ntg;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = k < npts;
  const int nseg = nt - 1;
  const T* vb = verts + static_cast<size_t>(b) * nt * 2;

  T px = T(0), py = T(0);
  if (active) {
    const int iu = k / ntg;
    const int it = k - iu * ntg;
    px = tgrid[static_cast<size_t>(b) * ntg + it];
    py = ugrid[static_cast<size_t>(b) * nu + iu];
  }

  T best = T(INFINITY), lbest = T(0), vx = T(0), vy = T(0);
  int ibest = 0;
  for (int base = 0; base < nseg; base += kTile) {
    const int n = min(kTile, nseg - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int s = base + j;
      const T x0x = vb[2 * s], x0y = vb[2 * s + 1];
      const T cx = vb[2 * s + 2] - x0x, cy = vb[2 * s + 3] - x0y;
      s_x0x[j] = x0x;
      s_x0y[j] = x0y;
      s_cx[j] = cx;
      s_cy[j] = cy;
      s_lsq[j] = cx * cx + cy * cy;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const T cx = s_cx[j], cy = s_cy[j];
        const T bx = px - s_x0x[j];
        const T by = py - s_x0y[j];
        const T bc = bx * cx + by * cy;
        T l = bc / s_lsq[j];
        l = l < T(0) ? T(0) : l;
        l = l > T(1) ? T(1) : l;
        const T dx = bx - l * cx;
        const T dy = by - l * cy;
        const T dsq = dx * dx + dy * dy;
        if (dsq < best) {
          best = dsq;
          ibest = base + j;
          lbest = l;
          vx = dx;
          vy = dy;
        }
      }
    }
  }
  if (active) {
    const size_t o = static_cast<size_t>(b) * npts + k;
    d[o] = sqrt(best);
    iclose[o] = ibest;
    lam[o] = lbest;
    dvec[2 * o] = vx;
    dvec[2 * o + 1] = vy;
  }
}

template <typename T>
int launch(const void* verts, const void* tgrid, const void* ugrid, void* d,
           void* iclose, void* lam, void* dvec, int batch, int nt, int ntg,
           int nu, void* stream) {
  const int npts = nu * ntg;
  const dim3 grid((npts + kThreads - 1) / kThreads, batch);
  distance_field_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(verts), static_cast<const T*>(tgrid),
      static_cast<const T*>(ugrid), static_cast<T*>(d),
      static_cast<int32_t*>(iclose), static_cast<T*>(lam),
      static_cast<T*>(dvec), nt, ntg, nu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 on success).
int wot_distance_field_f32(const void* verts, const void* tgrid,
                           const void* ugrid, void* d, void* iclose, void* lam,
                           void* dvec, int batch, int nt, int ntg, int nu,
                           void* stream) {
  return launch<float>(verts, tgrid, ugrid, d, iclose, lam, dvec, batch, nt,
                       ntg, nu, stream);
}

int wot_distance_field_f64(const void* verts, const void* tgrid,
                           const void* ugrid, void* d, void* iclose, void* lam,
                           void* dvec, int batch, int nt, int ntg, int nu,
                           void* stream) {
  return launch<double>(verts, tgrid, ugrid, d, iclose, lam, dvec, batch, nt,
                        ntg, nu, stream);
}

const char* wot_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
