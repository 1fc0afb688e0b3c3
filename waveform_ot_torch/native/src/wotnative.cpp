// wotnative — native validation solvers for waveform_ot_torch (the PyTorch
// package keeps its own copy of the JAX package's source).
//
// The reference's dependency closure reaches native code only through two
// optional third-party wheels (SURVEY.md section 2): POT's C++ network
// simplex (exact EMD, used by OTlib.wasserPOT / sinkhornPOT,
// libs/OTlib.py:906-928, 1015-1053) and scikit-fmm's C++ fast marching
// (the method='FMM' branch of waveformFP.calcpdf,
// libs/FingerprintLib.py:139-152).  Neither wheel is a dependency of this
// package, so this library provides self-contained equivalents:
//
//   wot_emd           exact solution of the dense transportation problem
//                     (balanced, real-valued masses) by successive shortest
//                     augmenting paths with node potentials — a simpler,
//                     degeneracy-free exact alternative to network simplex.
//   wot_fmm_distance  signed distance to the zero contour of a level-set
//                     field on a 2-D grid by the fast marching method with
//                     first- or second-order upwind differences (the same
//                     scheme skfmm implements).
//
// Host-side only: these are validation paths, built with g++ and bound by
// ctypes (waveform_ot_torch/native); the production compute path is the CUDA
// distance-field kernel and PyTorch on the card.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// ---------------------------------------------------------------------------
// Exact EMD: successive shortest paths with potentials (min-cost flow on the
// complete bipartite transportation graph; arcs are uncapacitated, flow is
// limited by supplies/demands).  Reduced costs stay non-negative, so every
// shortest-path pass is plain Dijkstra; each augmentation exhausts a source,
// a sink, or empties a carrying arc, so termination is guaranteed without
// the anti-cycling machinery a network simplex needs.
// ---------------------------------------------------------------------------

struct DenseDijkstra {
  // Linear-scan extract-min: V <= n+m is small for validation workloads and
  // the relaxation step is O(n*m) anyway.
  std::vector<double> dist;
  std::vector<int> parent;  // encodes the predecessor NODE
  std::vector<uint8_t> done;
};

}  // namespace

extern "C" {

// Solves min sum_ij F_ij C_ij  s.t.  sum_j F_ij = a_i, sum_i F_ij = b_j,
// F >= 0.  a (n) and b (m) must be non-negative; b is rescaled to match
// sum(a) (POT does the same balancing tolerance-check).
//
// C is row-major (n, m).  F (row-major n, m) receives the optimal plan.
// max_iter <= 0 selects the internal augmentation cap (n*m + n + m + 64).
// Returns the optimal cost.  *status: 0 ok, 1 bad input, 2 iteration cap
// or infeasible.
double wot_emd(int n, int m, const double* a_in, const double* b_in,
               const double* C, double* F, long max_iter, int* status) {
  *status = 0;
  if (n <= 0 || m <= 0) { *status = 1; return -1.0; }
  std::vector<double> a(a_in, a_in + n), b(b_in, b_in + m);
  double sa = 0.0, sb = 0.0;
  for (double v : a) { if (v < 0.0 || !std::isfinite(v)) { *status = 1; return -1.0; } sa += v; }
  for (double v : b) { if (v < 0.0 || !std::isfinite(v)) { *status = 1; return -1.0; } sb += v; }
  if (sa <= 0.0 || sb <= 0.0) { *status = 1; return -1.0; }
  const double scale = sa / sb;
  for (double& v : b) v *= scale;

  // Shift costs so reduced costs start non-negative with zero potentials
  // (a constant shift changes the objective by shift * total mass only).
  double cmin = kInf;
  for (int64_t k = 0; k < int64_t(n) * m; ++k) {
    if (!std::isfinite(C[k])) { *status = 1; return -1.0; }
    cmin = std::min(cmin, C[k]);
  }
  std::vector<double> cs(size_t(n) * m);
  for (int64_t k = 0; k < int64_t(n) * m; ++k) cs[k] = C[k] - cmin;
  // transposed copies: the sink-side Dijkstra relaxation walks a COLUMN
  // of cost/flow per pop; row-major column access is a cache miss per
  // element and dominated the runtime (~5x at 512x512)
  std::vector<double> cst(size_t(m) * n), Ft(size_t(m) * n, 0.0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j) cst[size_t(j) * n + i] = cs[size_t(i) * m + j];

  std::memset(F, 0, sizeof(double) * size_t(n) * m);
  const int V = n + m;  // nodes: [0,n) sources, [n,n+m) sinks
  std::vector<double> pi(V, 0.0);
  DenseDijkstra dj;
  dj.dist.resize(V);
  dj.parent.resize(V);
  dj.done.resize(V);

  // Flow-presence threshold for backward arcs (relative to total mass).
  const double eps = 1e-14 * std::max(1.0, sa);
  // Augmentation cap: each pass exhausts a node or empties an arc; nm+V is
  // a generous bound for well-posed inputs.
  const long max_aug = (max_iter > 0) ? max_iter : long(n) * m + V + 64;
  long aug = 0;

  for (;;) {
    // Supplies are zeroed EXACTLY by the bottleneck subtraction, so any
    // strictly positive remainder must still be routed — gating seeds on
    // an epsilon strands sub-eps masses (real fingerprint densities carry
    // exp tails < 1e-14 after normalization) and previously aborted with
    // status 2. Only a stranded remainder from the a/b rescale rounding
    // (no open sink left) is forgiven.
    double rem = 0.0;
    for (int i = 0; i < n; ++i) rem += a[i];
    if (rem <= 1e-12 * sa) break;  // fully routed (within rounding)
    if (++aug > max_aug) { *status = 2; return -1.0; }
    // Multi-source Dijkstra from all sources with remaining supply.
    std::fill(dj.dist.begin(), dj.dist.end(), kInf);
    std::fill(dj.parent.begin(), dj.parent.end(), -1);
    std::fill(dj.done.begin(), dj.done.end(), uint8_t{0});
    for (int i = 0; i < n; ++i)
      if (a[i] > 0.0) dj.dist[i] = 0.0;

    int tsink = -1;
    for (;;) {
      int v = -1;
      double best = kInf;
      for (int u = 0; u < V; ++u)
        if (!dj.done[u] && dj.dist[u] < best) { best = dj.dist[u]; v = u; }
      if (v < 0) break;  // nothing reachable
      dj.done[v] = 1;
      if (v >= n && b[v - n] > 0.0) { tsink = v; break; }  // nearest open sink
      if (v < n) {
        // source -> every sink, reduced cost c + pi[i] - pi[j]
        const double* crow = &cs[size_t(v) * m];
        const double base = dj.dist[v] + pi[v];
        for (int j = 0; j < m; ++j) {
          const int w = n + j;
          if (dj.done[w]) continue;
          const double nd = base + crow[j] - pi[w];
          if (nd < dj.dist[w] - 1e-18) { dj.dist[w] = nd; dj.parent[w] = v; }
        }
      } else {
        // sink -> sources currently carrying flow, reduced cost
        // -c + pi[j] - pi[i]
        const int j = v - n;
        const double base = dj.dist[v] + pi[v];
        const double* frow = &Ft[size_t(j) * n];
        const double* crow2 = &cst[size_t(j) * n];
        for (int i = 0; i < n; ++i) {
          if (dj.done[i] || frow[i] <= eps) continue;
          const double nd = base - crow2[i] - pi[i];
          if (nd < dj.dist[i] - 1e-18) { dj.dist[i] = nd; dj.parent[i] = v; }
        }
      }
    }
    if (tsink < 0) {
      // no open sink reachable: with exact zeroing this can only be the
      // tiny a-vs-b imbalance left by the rescale rounding — forgive it
      if (rem <= 1e-9 * sa) break;
      *status = 2;
      return -1.0;
    }

    // Johnson-style potential maintenance. Nodes not finalized before the
    // early exit (including dist == inf) must also advance by dist[t], or
    // residual arcs leaving them can acquire negative reduced costs.
    const double dt = dj.dist[tsink];
    for (int u = 0; u < V; ++u)
      pi[u] += std::min(dj.dist[u], dt);

    // Trace path sink -> source; bottleneck = min(remaining supply at the
    // path head, open demand at the sink, min flow on backward arcs).
    double delta = b[tsink - n];
    int v = tsink;
    while (dj.parent[v] >= 0) {
      const int u = dj.parent[v];
      if (u >= n) {  // backward arc (sink u) <- (source v): carries F[v][u-n]
        delta = std::min(delta, F[size_t(v) * m + (u - n)]);
      }
      v = u;
    }
    delta = std::min(delta, a[v]);  // v is the originating source

    v = tsink;
    while (dj.parent[v] >= 0) {
      const int u = dj.parent[v];
      if (u < n) {  // forward arc source u -> sink v
        F[size_t(u) * m + (v - n)] += delta;
        Ft[size_t(v - n) * n + u] += delta;
      } else {      // backward arc: remove flow source v -> sink u
        F[size_t(v) * m + (u - n)] -= delta;
        Ft[size_t(u - n) * n + v] -= delta;
      }
      v = u;
    }
    a[v] -= delta;
    b[tsink - n] -= delta;
  }

  double cost = 0.0;
  for (int64_t k = 0; k < int64_t(n) * m; ++k) cost += F[k] * C[k];
  return cost;
}

// ---------------------------------------------------------------------------
// Fast marching: signed distance to the zero contour of phi on an
// (nu, nt) grid with spacings (du, dt).  order in {1, 2} selects the
// upwind difference order (skfmm.distance defaults to 2).  out receives
// the signed distance (same sign convention as skfmm: sign of phi).
// Returns 0 on success, 1 on bad input, 2 if phi has no zero contour.
// ---------------------------------------------------------------------------

int wot_fmm_distance(int nu, int nt, const double* phi, double du, double dt,
                     int order, double* out) {
  if (nu <= 0 || nt <= 0 || du <= 0.0 || dt <= 0.0 ||
      (order != 1 && order != 2))
    return 1;
  const int64_t N = int64_t(nu) * nt;
  const double dx[2] = {du, dt};          // axis 0 = rows (u), axis 1 = cols (t)
  const int64_t stride[2] = {nt, 1};
  const int dim[2] = {nu, nt};

  enum : uint8_t { FAR = 0, TRIAL = 1, FROZEN = 2 };
  std::vector<uint8_t> state(N, FAR);
  std::vector<double> d(N, kInf);

  // --- interface initialization (skfmm scheme): a cell bordering a sign
  // change gets, per axis, the sub-cell distance theta*dx with
  // theta = phi_i / (phi_i - phi_j); axis contributions combine as
  // 1/d^2 = sum_k 1/d_k^2.
  bool any_frozen = false;
  for (int64_t idx = 0; idx < N; ++idx) {
    const double p = phi[idx];
    if (p == 0.0) { d[idx] = 0.0; state[idx] = FROZEN; any_frozen = true; continue; }
    const int i = int(idx / nt), j = int(idx % nt);
    const int ij[2] = {i, j};
    double inv2 = 0.0;
    for (int ax = 0; ax < 2; ++ax) {
      double dax = kInf;
      for (int s = -1; s <= 1; s += 2) {
        const int q = ij[ax] + s;
        if (q < 0 || q >= dim[ax]) continue;
        const double pn = phi[idx + s * stride[ax]];
        if (p * pn < 0.0) {
          const double theta = p / (p - pn);
          dax = std::min(dax, theta * dx[ax]);
        } else if (pn == 0.0) {
          dax = std::min(dax, dx[ax]);
        }
      }
      if (dax < kInf) inv2 += 1.0 / (dax * dax);
    }
    if (inv2 > 0.0) {
      d[idx] = 1.0 / std::sqrt(inv2);
      state[idx] = FROZEN;
      any_frozen = true;
    }
  }
  if (!any_frozen) return 2;

  using Node = std::pair<double, int64_t>;
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;

  // Upwind update of one cell from its frozen neighbours.
  struct AxisTerm {
    double t1;      // nearest frozen neighbour value (upwind root bound)
    double h;       // grid spacing on this axis
    double alpha2;  // 2nd-order weight (9/(4h^2)), 0 when unavailable
    double m2;      // 2nd-order target (4*T1 - T2)/3
  };
  auto update = [&](int64_t idx) -> double {
    const int i = int(idx / nt), j = int(idx % nt);
    const int ij[2] = {i, j};
    AxisTerm terms[2];
    int nax = 0;
    for (int ax = 0; ax < 2; ++ax) {
      double t1 = kInf;
      int sdir = 0;
      for (int s = -1; s <= 1; s += 2) {
        const int q = ij[ax] + s;
        if (q < 0 || q >= dim[ax]) continue;
        const int64_t nb = idx + s * stride[ax];
        if (state[nb] == FROZEN && d[nb] < t1) { t1 = d[nb]; sdir = s; }
      }
      if (t1 == kInf) continue;
      AxisTerm& tm = terms[nax++];
      tm.t1 = t1;
      tm.h = dx[ax];
      tm.alpha2 = 0.0;
      tm.m2 = 0.0;
      if (order == 2) {
        const int q2 = ij[ax] + 2 * sdir;
        if (q2 >= 0 && q2 < dim[ax]) {
          const int64_t nb2 = idx + 2 * sdir * stride[ax];
          if (state[nb2] == FROZEN && d[nb2] <= t1) {
            // second-order one-sided difference:
            // (3T - 4T1 + T2) / (2h)  =>  alpha = 9/(4h^2),
            // m = (4 T1 - T2) / 3
            tm.alpha2 = 9.0 / (4.0 * tm.h * tm.h);
            tm.m2 = (4.0 * t1 - d[nb2]) / 3.0;
          }
        }
      }
    }
    if (nax == 0) return kInf;
    // Solve sum_k alpha_k (T - m_k)^2 = 1 (largest root), accepting only
    // upwind solutions T >= T1 of EVERY axis used. Cascade: 2nd order
    // where available -> all 1st order -> drop the less-upwind axis.
    auto solve = [&](bool second, int use_nax) -> double {
      double A = 0.0, B = 0.0, Cq = -1.0, t1max = -kInf;
      for (int k = 0; k < use_nax; ++k) {
        const AxisTerm& tm = terms[k];
        double alpha, m;
        if (second && tm.alpha2 > 0.0) { alpha = tm.alpha2; m = tm.m2; }
        else { alpha = 1.0 / (tm.h * tm.h); m = tm.t1; }
        A += alpha;
        B -= 2.0 * alpha * m;
        Cq += alpha * m * m;
        t1max = std::max(t1max, tm.t1);
      }
      const double disc = B * B - 4.0 * A * Cq;
      if (disc < 0.0) return kInf;
      const double T = (-B + std::sqrt(disc)) / (2.0 * A);
      return (T >= t1max - 1e-15) ? T : kInf;
    };
    double T = solve(order == 2, nax);
    if (T < kInf) return T;
    T = solve(false, nax);
    if (T < kInf) return T;
    if (nax == 2) {
      // single-axis first-order update from the more-upwind axis
      const AxisTerm& tm = (terms[0].t1 <= terms[1].t1) ? terms[0] : terms[1];
      return tm.t1 + tm.h;
    }
    return terms[0].t1 + terms[0].h;
  };

  // Seed the heap with neighbours of the frozen band.
  for (int64_t idx = 0; idx < N; ++idx) {
    if (state[idx] != FROZEN) continue;
    const int i = int(idx / nt), j = int(idx % nt);
    const int ij[2] = {i, j};
    for (int ax = 0; ax < 2; ++ax)
      for (int s = -1; s <= 1; s += 2) {
        const int q = ij[ax] + s;
        if (q < 0 || q >= dim[ax]) continue;
        const int64_t nb = idx + s * stride[ax];
        if (state[nb] == FROZEN) continue;
        const double T = update(nb);
        if (T < d[nb]) {
          d[nb] = T;
          state[nb] = TRIAL;
          heap.emplace(T, nb);
        }
      }
  }

  while (!heap.empty()) {
    const auto [val, idx] = heap.top();
    heap.pop();
    if (state[idx] == FROZEN || val > d[idx]) continue;  // stale entry
    state[idx] = FROZEN;
    const int i = int(idx / nt), j = int(idx % nt);
    const int ij[2] = {i, j};
    for (int ax = 0; ax < 2; ++ax)
      for (int s = -1; s <= 1; s += 2) {
        const int q = ij[ax] + s;
        if (q < 0 || q >= dim[ax]) continue;
        const int64_t nb = idx + s * stride[ax];
        if (state[nb] == FROZEN) continue;
        const double T = update(nb);
        if (T < d[nb]) {
          d[nb] = T;
          state[nb] = TRIAL;
          heap.emplace(T, nb);
        }
      }
  }

  for (int64_t idx = 0; idx < N; ++idx)
    out[idx] = (phi[idx] < 0.0) ? -d[idx] : d[idx];
  return 0;
}

}  // extern "C"
