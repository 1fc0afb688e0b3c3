// Stage A of the layered f-k forward on Hopper (sm_90a): the surface operator
// of every (source depth, frequency, wavenumber) point of one frequency band
// and, when asked, its derivative in the source depth, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves stage A to XLA's fusion
// (waveform_ot_tpu/models/layered.py). It was added because the eager
// PyTorch version, waveform_ot_torch.models.layered._surface_operator with
// _depth_tangent (the plain version, which CPU tensors still take), issues
// about 1,266 elementwise launches per band, whatever the number of
// sources, each one pass of (K, nf, nk) complex128 arrays through device
// memory.
//
// What each point computes, as the plain version does (z down; P-SV fields
// in 2x2 complex blocks, SH in scalars):
//  * the eigenblocks of each layer, the vertical wavenumbers by the
//    decaying-phase square root (Im >= 0, as _CSqrt.forward);
//  * the P-SV and SH interface R/T (_interface2, _interfacesh) and the
//    free-surface reflection;
//  * the B-stack (source level down to the half-space) and the A-stack
//    (free surface down to the source level), Kennett compositions of the
//    interfaces and the partial layer thicknesses;
//  * _Reverb (W2, RA2, RB2, inner2 and the SH scalars), _SourceLayer (ga,
//    gb and chi of the source layer, its vs and rho), and with the tangent
//    the closed form of _depth_tangent.
//
// What bounds it on the card. A point of the six-layer Fukuoka crust costs
// some 10,000 float64 operations, among them ~14 complex exponentials, ~28
// square roots and ~40 complex reciprocals, and writes 368 bytes (688 with
// the tangent). At 1.7 M points (64 sources) that is ~17 GFLOP against
// ~1.2 GB: the float64 arithmetic binds, not memory. Compiled with
// -fmad=false (_build.py), so no mul+add pair fuses, and the reachable
// ceiling is about half the card's FMA-counted float64 peak. Registers
// bind too: the stack of one sweep, the layers and an interface solve take
// all 255 a thread may have (a few hundred bytes spill), so an SM holds 8
// warps.
//
// Design, in the order of what it buys.
//  * Everything stays in registers. The plain version writes and reads
//    back every intermediate of the recursion; here only the outputs are
//    written, each field to its own contiguous array in the plain
//    version's layout, so stage B reads them unchanged.
//  * One thread per point, wavenumber fastest. A warp then shares its
//    source and frequency, so its branches (the source layer, zero partial
//    thicknesses) agree, and its stores are adjacent. Sharing the interface
//    solves among the sources of a (frequency, wavenumber) point instead
//    was 13% slower for one source and 21% faster for 64 (PERF.md); the
//    single-model calls have one.
//  * Only what applies is composed. The plain version composes every
//    interface into both stacks, masked to the identity two-port on the
//    wrong side of the source, and every layer phase, at zero thickness
//    where none applies. Composing the identity two-port, or a phase of
//    zero thickness, changes nothing but the sign of a zero, so the kernel
//    composes each interface into the one stack its mask selects and skips
//    zero thicknesses. Each stack is one sweep down the layers; the
//    B-stack's sweep runs first, so the A-stack's sweep carries only RB.
//  * The plain version's arithmetic in the plain version's order
//    (c10::complex's product and quotient, a real times a complex as the
//    product of its parts, exp and sincos for the phase, hypot and sqrt for
//    the square root), except that a 2x2 inverse and an SH interface take
//    one reciprocal and multiply where the plain version divides each
//    entry: 2 divisions in place of 8, which took 40% off the kernel's
//    time. PyTorch's own elementwise kernels may also contract a mul+add
//    where this file does not. So the two agree to rounding, not bit for
//    bit, and where the recursion magnifies rounding (the low-frequency
//    lanes) both are as far from the exact answer
//    (tests/test_torch_stage_a.py).
//  * Indices are 64-bit, so any K * nf * nk that one launch holds works.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

enum Field {
  kW2, kRA2, kRB2, kInner2, kWsh, kRAsh, kRBsh, kInnersh,   // _Reverb
  kGa, kGb, kChi, kVs, kRho,                                // _SourceLayer
  kDW2, kDRA2, kDRB2, kDInner2, kDWsh, kDRAsh, kDRBsh, kDInnersh,  // tangent
  kFields
};

struct C {
  double re, im;
};

__device__ __forceinline__ C add(C a, C b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ C sub(C a, C b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ C neg(C a) { return {-a.re, -a.im}; }
__device__ __forceinline__ C mul(C a, C b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// a real times a complex
__device__ __forceinline__ C mul(double r, C a) { return {r * a.re, r * a.im}; }
// 1j * a
__device__ __forceinline__ C mul_i(C a) { return {-a.im, a.re}; }

// c10::complex's quotient (numpy's, Smith's scaling)
__device__ __forceinline__ C div(C x, C y) {
  const double a = x.re, b = x.im, c = y.re, d = y.im;
  const double abs_c = fabs(c), abs_d = fabs(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0 && abs_d == 0.0) return {a / abs_c, b / abs_d};
    const double rat = d / c;
    const double scl = 1.0 / (c + d * rat);
    return {(a + b * rat) * scl, (b - a * rat) * scl};
  }
  const double rat = c / d;
  const double scl = 1.0 / (d + c * rat);
  return {(a * rat + b) * scl, (b * rat - a) * scl};
}
// 1 / a
__device__ __forceinline__ C recip(C a) { return div(C{1.0, 0.0}, a); }
// a complex over a positive real: c10's quotient by (r, 0) is x * (1 / r)
// to the bit, sign of zero aside, with one division in place of two
__device__ __forceinline__ C div(C x, double r) { return mul(1.0 / r, x); }

__device__ __forceinline__ C cexp(C a) {
  const double e = exp(a.re);
  double s, c;
  sincos(a.im, &s, &c);
  return {e * c, e * s};
}

// principal sqrt with Im >= 0 on the negative real axis for +0.0 and -0.0
// imaginary parts alike (_CSqrt.forward)
__device__ __forceinline__ C csqrt(C z) {
  const double t = sqrt(0.5 * (hypot(z.re, z.im) + fabs(z.re)));
  const double t_safe = t == 0.0 ? 1.0 : t;
  if (z.re >= 0.0) return {t, 0.5 * z.im / t_safe};
  return {0.5 * fabs(z.im) / t_safe, z.im >= 0.0 ? t : -t};
}

// a 2x2 complex matrix [[a, b], [c, d]]
struct M2 {
  C a, b, c, d;
};

__device__ __forceinline__ M2 add(const M2& x, const M2& y) {
  return {add(x.a, y.a), add(x.b, y.b), add(x.c, y.c), add(x.d, y.d)};
}
__device__ __forceinline__ M2 sub(const M2& x, const M2& y) {
  return {sub(x.a, y.a), sub(x.b, y.b), sub(x.c, y.c), sub(x.d, y.d)};
}
__device__ __forceinline__ M2 neg(const M2& x) {
  return {neg(x.a), neg(x.b), neg(x.c), neg(x.d)};
}
// out[i][j] = x[i][0] y[0][j] + x[i][1] y[1][j], as _mm
__device__ __forceinline__ M2 mm(const M2& x, const M2& y) {
  return {add(mul(x.a, y.a), mul(x.b, y.c)), add(mul(x.a, y.b), mul(x.b, y.d)),
          add(mul(x.c, y.a), mul(x.d, y.c)), add(mul(x.c, y.b), mul(x.d, y.d))};
}
__device__ __forceinline__ M2 mm(const M2& x, const M2& y, const M2& z) {
  return mm(mm(x, y), z);
}
__device__ __forceinline__ M2 mm(const M2& w, const M2& x, const M2& y,
                                 const M2& z) {
  return mm(mm(mm(w, x), y), z);
}
// the inverse by one reciprocal of the determinant, where _inv2 divides
// each entry by it: a rounding apart, with 2 divisions in place of 8
__device__ __forceinline__ M2 inv2(const M2& m) {
  const C r = recip(sub(mul(m.a, m.d), mul(m.b, m.c)));
  return {mul(m.d, r), neg(mul(m.b, r)), neg(mul(m.c, r)), mul(m.a, r)};
}
__device__ __forceinline__ M2 zero2() {
  return {{0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}};
}
__device__ __forceinline__ M2 eye2() {
  return {{1.0, 0.0}, {0.0, 0.0}, {0.0, 0.0}, {1.0, 0.0}};
}
// I - m, as PyTorch subtracts from the identity
__device__ __forceinline__ M2 eye_minus(const M2& m) { return sub(eye2(), m); }

// a layer's material at one (frequency, wavenumber) point
struct Layer {
  C ga, gb, chi;
  double mu;
};

struct Args {
  const double* k;      // (nk,)
  const double* om;     // (nf, 2) complex frequencies omega + i alpha
  const double* iface;  // (nlay - 1,) interface depths
  const double* vp;     // (nlay,)
  const double* vs;
  const double* rho;
  const double* z;      // (K,) source depths
  double* out[kFields];
  int nsrc, nf, nk, nlay;
  int free_surface, tangent;
};

// _psv_blocks' quantities of layer i
__device__ __forceinline__ Layer layer(const Args& a, int i, double k, C w2) {
  const double vp = a.vp[i], vs = a.vs[i], rho = a.rho[i];
  const double kk = k * k;
  const C pa = div(w2, vp * vp);
  const C pb = div(w2, vs * vs);
  Layer l;
  l.ga = csqrt(C{pa.re - kk, pa.im - 0.0});
  l.gb = csqrt(C{pb.re - kk, pb.im - 0.0});
  l.mu = rho * vs * vs;
  l.chi = C{2.0 * k * k - pb.re, 0.0 - pb.im};
  return l;
}

struct Blocks {
  M2 Ud, Uu, Sd, Su;
};

__device__ __forceinline__ Blocks blocks(const Layer& l, double k) {
  const C ik{0.0, k};
  const C iga = mul_i(l.ga), igb = mul_i(l.gb);
  const C s0 = mul(l.mu, l.chi), s3 = mul(-l.mu, l.chi);
  const C sb = mul(-2.0 * l.mu, mul(k, l.gb)), sc = mul(-2.0 * l.mu, mul(k, l.ga));
  return {{ik, neg(igb), iga, ik}, {ik, igb, neg(iga), ik}, {s0, sb, sc, s3},
          {s0, neg(sb), neg(sc), s3}};
}

struct Stack2 {
  M2 RD, TD, RU, TU;
};
struct StackSH {
  C RD, TD, RU, TU;
};

// P-SV interface R/T between layer 1 (above) and layer 2 (below)
__device__ __forceinline__ Stack2 interface2(const Blocks& b1, const Blocks& b2) {
  const M2 iUd2 = inv2(b2.Ud), iUu1 = inv2(b1.Uu);
  const M2 sd = mm(b2.Sd, iUd2), su = mm(b1.Su, iUu1);
  Stack2 r;
  r.RD = mm(inv2(sub(b1.Su, mm(sd, b1.Uu))), sub(mm(sd, b1.Ud), b1.Sd));
  r.TD = mm(iUd2, add(b1.Ud, mm(b1.Uu, r.RD)));
  r.RU = mm(inv2(sub(b2.Sd, mm(su, b2.Ud))), sub(mm(su, b2.Uu), b2.Su));
  r.TU = mm(iUu1, add(b2.Uu, mm(b2.Ud, r.RU)));
  return r;
}

__device__ __forceinline__ StackSH interfacesh(const Layer& l1, const Layer& l2) {
  const C z1 = mul(l1.mu, l1.gb), z2 = mul(l2.mu, l2.gb);
  const C r = recip(add(z1, z2));
  return {mul(sub(z1, z2), r), mul(mul(2.0, z1), r), mul(sub(z2, z1), r),
          mul(mul(2.0, z2), r)};
}

// _stack2_compose(s, t) and _stacksh_compose(s, t)
__device__ __forceinline__ void compose(Stack2& s, const Stack2& t) {
  const M2 x = inv2(eye_minus(mm(s.RU, t.RD)));
  const M2 y = add(eye2(), mm(t.RD, x, s.RU));
  const M2 rd = add(s.RD, mm(s.TU, t.RD, x, s.TD));
  const M2 td = mm(t.TD, x, s.TD);
  const M2 ru = add(t.RU, mm(t.TD, s.RU, y, t.TU));
  const M2 tu = mm(s.TU, y, t.TU);
  s = {rd, td, ru, tu};
}

__device__ __forceinline__ void compose(StackSH& s, const StackSH& t) {
  const C x = recip(sub(C{1.0, 0.0}, mul(s.RU, t.RD)));
  const C rd = add(s.RD, mul(mul(mul(s.TU, t.RD), x), s.TD));
  const C td = mul(mul(t.TD, x), s.TD);
  const C ru = add(t.RU, mul(mul(mul(t.TD, s.RU), x), t.TU));
  const C tu = mul(mul(s.TU, x), t.TU);
  s = {rd, td, ru, tu};
}

// composition with a layer of thickness h: R = 0, T = diag(e_a, e_b)
__device__ __forceinline__ void phase(Stack2& s, StackSH& sh, const Layer& l,
                                      double h) {
  const C ea = cexp(mul(h, mul_i(l.ga))), eb = cexp(mul(h, mul_i(l.gb)));
  s.TD = {mul(s.TD.a, ea), mul(s.TD.b, ea), mul(s.TD.c, eb), mul(s.TD.d, eb)};
  s.RU = {mul(mul(s.RU.a, ea), ea), mul(mul(s.RU.b, eb), ea),
          mul(mul(s.RU.c, ea), eb), mul(mul(s.RU.d, eb), eb)};
  s.TU = {mul(s.TU.a, ea), mul(s.TU.b, eb), mul(s.TU.c, ea), mul(s.TU.d, eb)};
  sh.TD = mul(eb, sh.TD);
  sh.RU = mul(mul(eb, sh.RU), eb);
  sh.TU = mul(sh.TU, eb);
}

__device__ __forceinline__ void identity(Stack2& s, StackSH& sh) {
  s = {zero2(), eye2(), zero2(), eye2()};
  sh = {{0.0, 0.0}, {1.0, 0.0}, {0.0, 0.0}, {1.0, 0.0}};
}

__device__ __forceinline__ void put(double* out, long long p, C v) {
  reinterpret_cast<double2*>(out)[p] = make_double2(v.re, v.im);
}
__device__ __forceinline__ void put(double* out, long long p, const M2& m) {
  double2* o = reinterpret_cast<double2*>(out) + 4 * p;
  o[0] = make_double2(m.a.re, m.a.im);
  o[1] = make_double2(m.b.re, m.b.im);
  o[2] = make_double2(m.c.re, m.c.im);
  o[3] = make_double2(m.d.re, m.d.im);
}

__global__ void __launch_bounds__(kThreads) surface_kernel(const Args a) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<long long>(a.nsrc) * a.nf * a.nk) return;
  const int ik = static_cast<int>(p % a.nk);
  const int f = static_cast<int>((p / a.nk) % a.nf);
  const int s = static_cast<int>(p / (static_cast<long long>(a.nk) * a.nf));
  const double z = a.z[s];
  const double k = a.k[ik];
  const C om{a.om[2 * f], a.om[2 * f + 1]};
  const C w2 = mul(om, om);
  const int n = a.nlay;
  // the plain version's masks: in_a[i] = iface[i] <= z; the source layer
  // searchsorted(iface, z, right=True), the count of interfaces at or above z
  int ls = 0;
  for (int i = 0; i + 1 < n; ++i) ls += a.iface[i] <= z;
  const auto top = [&](int i) { return i == 0 ? 0.0 : a.iface[i - 1]; };

  Stack2 s2;
  StackSH ssh;
  // B-stack: layer i's thickness below the source, then interface i where
  // it lies below the source; the half-space's phase cannot change RD
  identity(s2, ssh);
  Layer cur = layer(a, 0, k, w2);
  for (int i = 0; i + 1 < n; ++i) {
    const double zb = a.iface[i] < 1e9 ? a.iface[i] : 1e9;
    const double h = zb - (top(i) > z ? top(i) : z);
    if (h > 0.0 || h != h) phase(s2, ssh, cur, h);
    const Layer nxt = layer(a, i + 1, k, w2);
    if (!(a.iface[i] <= z)) {
      compose(s2, interface2(blocks(cur, k), blocks(nxt, k)));
      compose(ssh, interfacesh(cur, nxt));
    }
    cur = nxt;
  }
  const M2 RB2 = s2.RD;
  const C RBsh = ssh.RD;

  // A-stack: interface i - 1 where it lies at or above the source, then
  // layer i's thickness above the source
  identity(s2, ssh);
  cur = layer(a, 0, k, w2);
  for (int i = 0; i < n; ++i) {
    const double zb = i + 1 < n ? a.iface[i] : INFINITY;
    const double h = (zb < z ? zb : z) - top(i);
    if (h > 0.0 || h != h) phase(s2, ssh, cur, h);
    if (i + 1 == n) break;
    const Layer nxt = layer(a, i + 1, k, w2);
    if (a.iface[i] <= z) {
      compose(s2, interface2(blocks(cur, k), blocks(nxt, k)));
      compose(ssh, interfacesh(cur, nxt));
    }
    cur = nxt;
  }

  // receiver map: upgoing at the source level -> displacement at z = 0,
  // with the free-surface conversion and the A-stack's reverberations
  const Layer top_layer = layer(a, 0, k, w2);
  const Blocks b0 = blocks(top_layer, k);
  const M2 RF2 = a.free_surface ? neg(mm(inv2(b0.Sd), b0.Su)) : zero2();
  const double rfsh = a.free_surface ? 1.0 : 0.0;
  const M2 WF2 = add(b0.Uu, mm(b0.Ud, RF2));
  const M2 rev2 = inv2(eye_minus(mm(s2.RD, RF2)));
  const M2 W2 = mm(WF2, rev2, s2.TU);
  const M2 RA2 = add(s2.RU, mm(s2.TD, RF2, rev2, s2.TU));
  const C revsh = recip(sub(C{1.0, 0.0}, mul(rfsh, ssh.RD)));
  const C Wsh = mul(mul(1.0 + rfsh, revsh), ssh.TU);
  const C RAsh = add(ssh.RU, mul(mul(mul(rfsh, ssh.TD), revsh), ssh.TU));
  const M2 inner2 = inv2(eye_minus(mm(RA2, RB2)));
  const C innersh = recip(sub(C{1.0, 0.0}, mul(RAsh, RBsh)));

  put(a.out[kW2], p, W2);
  put(a.out[kRA2], p, RA2);
  put(a.out[kRB2], p, RB2);
  put(a.out[kInner2], p, inner2);
  put(a.out[kWsh], p, Wsh);
  put(a.out[kRAsh], p, RAsh);
  put(a.out[kRBsh], p, RBsh);
  put(a.out[kInnersh], p, innersh);
  const Layer src = layer(a, ls, k, w2);
  put(a.out[kGa], p, src.ga);
  put(a.out[kGb], p, src.gb);
  put(a.out[kChi], p, src.chi);
  if (f == 0 && ik == 0) {
    a.out[kVs][s] = a.vs[ls];
    a.out[kRho][s] = a.rho[ls];
  }
  if (!a.tangent) return;

  // d/dz: the source layer's partial phases E_a (above) and E_b (below)
  // are the only depth dependence, so W2 = W E_a, RA2 = E_a RA E_a and
  // RB2 = E_b RB E_b, and d/dz multiplies by iG = diag(i ga, i gb) from the
  // sides (_depth_tangent)
  const C iga = mul_i(src.ga), igb = mul_i(src.gb);
  const auto sides = [&](const M2& m) {
    return M2{add(mul(iga, m.a), mul(m.a, iga)), add(mul(iga, m.b), mul(m.b, igb)),
              add(mul(igb, m.c), mul(m.c, iga)), add(mul(igb, m.d), mul(m.d, igb))};
  };
  const M2 dRA2 = sides(RA2), dRB2 = neg(sides(RB2));
  const C dRAsh = mul(mul(2.0, igb), RAsh), dRBsh = mul(mul(-2.0, igb), RBsh);
  put(a.out[kDW2], p, M2{mul(W2.a, iga), mul(W2.b, igb), mul(W2.c, iga), mul(W2.d, igb)});
  put(a.out[kDRA2], p, dRA2);
  put(a.out[kDRB2], p, dRB2);
  put(a.out[kDInner2], p, mm(inner2, add(mm(dRA2, RB2), mm(RA2, dRB2)), inner2));
  put(a.out[kDWsh], p, mul(igb, Wsh));
  put(a.out[kDRAsh], p, dRAsh);
  put(a.out[kDRBsh], p, dRBsh);
  put(a.out[kDInnersh], p,
      mul(mul(innersh, innersh), add(mul(dRAsh, RBsh), mul(RAsh, dRBsh))));
}

}  // namespace

extern "C" {

// Computes one band's surface operator into the kFields arrays of ``out``
// (host array of device pointers, in the order of enum Field; the tangent's
// may be null when ``tangent`` is 0). Returns cudaGetLastError() right
// after the launch (0 on success), or cudaErrorInvalidConfiguration for
// more points than one launch holds.
int wot_surface_operator(const void* k, const void* om, const void* iface,
                         const void* vp, const void* vs, const void* rho,
                         const void* z, void* const* out, int nsrc, int nf,
                         int nk, int nlay, int free_surface, int tangent,
                         void* stream) {
  Args a;
  a.k = static_cast<const double*>(k);
  a.om = static_cast<const double*>(om);
  a.iface = static_cast<const double*>(iface);
  a.vp = static_cast<const double*>(vp);
  a.vs = static_cast<const double*>(vs);
  a.rho = static_cast<const double*>(rho);
  a.z = static_cast<const double*>(z);
  for (int i = 0; i < kFields; ++i) a.out[i] = static_cast<double*>(out[i]);
  a.nsrc = nsrc;
  a.nf = nf;
  a.nk = nk;
  a.nlay = nlay;
  a.free_surface = free_surface;
  a.tangent = tangent;
  const long long points = static_cast<long long>(nsrc) * nf * nk;
  const long long blocks = (points + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  surface_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* wot_surface_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
