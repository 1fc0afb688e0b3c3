// Polyline nearest-distance field on Hopper (sm_90a), batched over traces.
//
// Replaces the Pallas TPU kernel waveform_ot_tpu/ops/pallas_distance.py
// (_kernel, launched by _distance_field_pallas_impl). For every point p of
// each trace's (nu, ntg) grid and every segment (x0, c) of that trace's
// polyline, with il = 1/|c|^2 staged once per segment:
//
//     b = p - x0;  lam = clip(b.c * il, 0, 1);  dsq = |b - lam*c|^2
//
// and it writes d = sqrt(min dsq), the first-tie argmin segment, the winning
// lam and the offset p - x* (interleaved (B, nu, ntg, 2), the JAX layout).
//
// What bounds it on the card. Each point-segment pair costs 16 operations
// (2 for b, 3 for b.c, 1 for the scale by il, 2 for the clip, 4 for dx and
// dy, 3 for dsq, 1 for the compare), while each grid point writes 20 bytes
// (f32) or 36 bytes (f64). At every shape of the main path (tens to hundreds
// of segments) the arithmetic binds, not memory. The file is compiled with
// -fmad=false (see _build.py): a contracted mul+add moves d near the
// polyline and flips winners at exact ties, so no pair is fused and about
// half of the card's FMA-counted FP32/FP64 peak is the reachable ceiling.
//
// Design, in the order of what it buys.
//  * P = 4 points per thread. A thread owns P consecutive time points of
//    one amplitude row. Per segment it reads the segment from shared memory once
//    (one vector x0x, x0y, cx, cy and the scalar il) and forms by = py - x0y
//    and by*cy once for all P points. Each pair still gets the same
//    operations in the same order. Points past the row's end repeat the last
//    point and are not written.
//  * S lanes per point group at small batches. When the B*nu*ceil(ntg/P)
//    groups are too few to fill the card, S adjacent lanes of a warp share a
//    group and lane s walks segments s, s+S, s+2S, ... Each lane keeps the
//    first minimum of its ascending walk (strict <). The lanes are combined
//    by warp shuffles on the key (dsq, segment index): the smaller dsq wins,
//    and on an exact tie the lower index. That is np.argmin's first-minimum
//    rule over all segments. S is chosen by the wrapper
//    (ops/cuda_distance.plan) from (B, nu, ntg, nseg); every S it can
//    choose is instantiated here.
//  * No division per pair: il = 1/|c|^2 is staged with the segment table, as
//    _pack_segments does for the TPU kernel, and lam = (b.c) * il.
//  * Only (dsq, index) is carried per point. The winner's lam and offset are
//    computed once at the end from its segment, with the same operations in
//    the same order as in the loop, hence to the same bits.
//  * Arithmetic identical to the plain PyTorch version
//    (waveform_ot_torch.ops.fingerprint.distance_field_torch): grid
//    coordinates are read from tgrid/ugrid, il is an IEEE reciprocal, the
//    clip agrees with torch.clamp on every number, and no mul+add is
//    contracted. They part only at a zero-length segment, where lam is NaN
//    (0 * inf): the plain version, like JAX, keeps it and lets the NaN win
//    the argmin. This kernel takes lam = 0 in f32, so the segment counts as
//    its point, and keeps the NaN in f64, so the segment is skipped (dsq <
//    best is false). d is the same both ways, as the neighbouring segments
//    end and start at that point; only the index named differs. A trace
//    with increasing sample times has no such segment.
//  * The block stages its trace's segment table in shared memory, kTile
//    segments at a time (1024 x 40 bytes of doubles, under the 48 KB static
//    limit), so any segment count works.
//  * One launch for any batch: the grid is one-dimensional, each trace's
//    blocks adjacent (trace b owns blocks [b*per_trace, (b+1)*per_trace)),
//    so the batch is bounded by gridDim.x (2^31 - 1 blocks), not by
//    gridDim.y's 65,535. Offsets into the (B, ...) arrays are size_t; the
//    int products stay within one trace (nu*ntg*2 and 2*nt below 2^31,
//    checked by the wrapper).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int P = 4;  // grid points per thread

// One segment's origin and direction: a 16-byte (f32) or 32-byte (f64)
// vector load from shared memory.
template <typename T>
struct alignas(4 * sizeof(T)) Seg {
  T x0x, x0y, cx, cy;
};

// Clip to [0, 1]. The forms are the fastest measured (ab_distance_field.py
// --old on variants): in f32 fmaxf/fminf, one instruction each (a NaN-keeping
// max.NaN/min.NaN was ~11% slower at loc64); in f64 a compare and select that
// keeps a NaN (fmax/fmin, or selects that take a NaN to 0, were 7-16%
// slower). They differ only for lam = NaN, see the source note above.
__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ double clip01(double x) {
  x = x < 0.0 ? 0.0 : x;
  return x > 1.0 ? 1.0 : x;
}

template <typename T>
struct Args {
  const T* verts;
  const T* tgrid;
  const T* ugrid;
  T* d;
  int32_t* iclose;
  T* lam;
  T* dvec;
  int batch, nt, ntg, nu;
  cudaStream_t stream;
};

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, 1)
distance_field_kernel(const Args<T> a) {
  static_assert(S >= 1 && S <= 32 && (S & (S - 1)) == 0, "S: power of two <= 32");
  __shared__ Seg<T> s_seg[kTile];
  __shared__ T s_il[kTile];

  constexpr int kGroups = kThreads / S;  // point groups per block
  const int ntg = a.ntg, nu = a.nu, nseg = a.nt - 1;
  const int ngr = (ntg + P - 1) / P;  // point groups per amplitude row
  const int per_trace = (nu * ngr + kGroups - 1) / kGroups;  // blocks per trace
  const int b = static_cast<int>(blockIdx.x / per_trace);
  const int g = static_cast<int>(blockIdx.x - static_cast<unsigned>(b) * per_trace) * kGroups
                + threadIdx.x / S;
  const int lane = threadIdx.x % S;  // this lane's slice of the segments
  const bool active = g < nu * ngr;
  const T* vb = a.verts + static_cast<size_t>(b) * a.nt * 2;

  const int iu = active ? g / ngr : 0;
  const int it0 = active ? (g - iu * ngr) * P : 0;
  const T py = a.ugrid[static_cast<size_t>(b) * nu + iu];
  T px[P];
#pragma unroll
  for (int p = 0; p < P; ++p)
    px[p] = a.tgrid[static_cast<size_t>(b) * ntg + min(it0 + p, ntg - 1)];

  T best[P];
  int ibest[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = T(INFINITY);
    ibest[p] = 0;
  }

  for (int base = 0; base < nseg; base += kTile) {
    const int n = min(kTile, nseg - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int s = base + j;
      const T x0x = vb[2 * s], x0y = vb[2 * s + 1];
      const T cx = vb[2 * s + 2] - x0x, cy = vb[2 * s + 3] - x0y;
      s_seg[j] = Seg<T>{x0x, x0y, cx, cy};
      s_il[j] = T(1) / (cx * cx + cy * cy);
    }
    __syncthreads();
    if (active) {
      for (int j = lane; j < n; j += S) {
        const Seg<T> sg = s_seg[j];
        const T il = s_il[j];
        const T by = py - sg.x0y;
        const T byc = by * sg.cy;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const T bx = px[p] - sg.x0x;
          const T bc = bx * sg.cx + byc;
          const T l = clip01(bc * il);
          const T dx = bx - l * sg.cx;
          const T dy = by - l * sg.cy;
          const T dsq = dx * dx + dy * dy;
          if (dsq < best[p]) {
            best[p] = dsq;
            ibest[p] = base + j;
          }
        }
      }
    }
  }

  // Combine the S lanes of each group: lexicographic min of (dsq, index).
  // Every lane of the warp takes part, active or not.
#pragma unroll
  for (int off = S / 2; off > 0; off /= 2) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const T od = __shfl_xor_sync(0xffffffffu, best[p], off);
      const int oi = __shfl_xor_sync(0xffffffffu, ibest[p], off);
      if (od < best[p] || (od == best[p] && oi < ibest[p])) {
        best[p] = od;
        ibest[p] = oi;
      }
    }
  }

  if (!active) return;
  const size_t row = (static_cast<size_t>(b) * nu + iu) * ntg;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p % S != lane || it0 + p >= ntg) continue;
    // the winner again, with the loop's operations in the loop's order
    const int i = ibest[p];
    const T x0x = vb[2 * i], x0y = vb[2 * i + 1];
    const T cx = vb[2 * i + 2] - x0x, cy = vb[2 * i + 3] - x0y;
    const T il = T(1) / (cx * cx + cy * cy);
    const T bx = px[p] - x0x;
    const T by = py - x0y;
    const T bc = bx * cx + by * cy;
    const T l = clip01(bc * il);
    const T dx = bx - l * cx;
    const T dy = by - l * cy;
    const size_t o = row + it0 + p;
    a.d[o] = sqrt(dx * dx + dy * dy);
    a.iclose[o] = i;
    a.lam[o] = l;
    a.dvec[2 * o] = dx;
    a.dvec[2 * o + 1] = dy;
  }
}

template <typename T, int S>
cudaError_t launch_s(const Args<T>& a) {
  constexpr long long kGroups = kThreads / S;
  const long long groups = static_cast<long long>(a.nu) * ((a.ntg + P - 1) / P);
  const long long blocks = (groups + kGroups - 1) / kGroups * a.batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  distance_field_kernel<T, S>
      <<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* verts, const void* tgrid, const void* ugrid, void* d,
           void* iclose, void* lam, void* dvec, int batch, int nt, int ntg,
           int nu, int s, void* stream) {
  const Args<T> a{static_cast<const T*>(verts), static_cast<const T*>(tgrid),
                  static_cast<const T*>(ugrid), static_cast<T*>(d),
                  static_cast<int32_t*>(iclose), static_cast<T*>(lam),
                  static_cast<T*>(dvec), batch, nt, ntg, nu,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t rc;
  switch (s) {
    case 1: rc = launch_s<T, 1>(a); break;
    case 2: rc = launch_s<T, 2>(a); break;
    case 4: rc = launch_s<T, 4>(a); break;
    case 8: rc = launch_s<T, 8>(a); break;
    case 16: rc = launch_s<T, 16>(a); break;
    case 32: rc = launch_s<T, 32>(a); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() right after the launch (0 on success),
// cudaErrorInvalidValue for an s that is not instantiated, or
// cudaErrorInvalidConfiguration for a batch past gridDim.x.
int wot_distance_field_f32(const void* verts, const void* tgrid,
                           const void* ugrid, void* d, void* iclose, void* lam,
                           void* dvec, int batch, int nt, int ntg, int nu,
                           int s, void* stream) {
  return launch<float>(verts, tgrid, ugrid, d, iclose, lam, dvec, batch, nt,
                       ntg, nu, s, stream);
}

int wot_distance_field_f64(const void* verts, const void* tgrid,
                           const void* ugrid, void* d, void* iclose, void* lam,
                           void* dvec, int batch, int nt, int ntg, int nu,
                           int s, void* stream) {
  return launch<double>(verts, tgrid, ugrid, d, iclose, lam, dvec, batch, nt,
                        ntg, nu, s, stream);
}

const char* wot_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
