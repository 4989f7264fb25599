// The edge arithmetic of P2: ops/decode.py refine_edges_plain for one edge
// sample, one edge and one corner of a quad slot. Included by refine.cu; it
// also compiles as plain C++ (no CUDA header), so that the same arithmetic
// can be built by a host compiler (with -ffp-contract=off) and held against
// the plain version on the CPU.
//
// Order of operations: the plain version's, each Python expression left to
// right as it is written (`1 + k1*r2 + k2*r2*r2 + k3*r2*r2*r2` is
// ((1 + k1 r2) + (k2 r2) r2) + ((k3 r2) r2) r2), every f32 operation
// rounded once through pose.cuh's mul/add/sub/dvd/root (the __f*_rn
// intrinsics on the card, which nvcc never contracts into an FMA). So every
// sample position and pixel index, every weight and every undistorted point
// has the plain version's bits. The six moment sums are the one place where
// the order is the kernel's own (thread_sums below, then refine.cu's
// block tree); torch's order for its sum over two axes is not specified.
// atan2, sin and cos are evaluated in f64 and rounded to f32, as
// ops/mathf.py does it.
//
// Pixel sampling is _int_sample's: truncate toward zero, in bounds when
// px >= 0, py >= 0, trunc(px) < w and trunc(py) < h. For px >= 0 that last
// test is px < w, which also holds NaN and positions past 2^31 out, as the
// card's float-to-int conversion (it saturates) does; torch on the CPU
// converts those to INT_MIN, so the two can differ there and nowhere else.
#pragma once
#include <math.h>
#include <stdint.h>

#include "pose.cuh"

namespace rvt_refine {

using rvt_pose::add;
using rvt_pose::atan2_f64;
using rvt_pose::cos_f64;
using rvt_pose::dvd;
using rvt_pose::mul;
using rvt_pose::root;
using rvt_pose::sin_f64;
using rvt_pose::sub;

#define RVT_REFINE_FN RVT_POSE_FN

constexpr int kNormalSteps = 25;  // decode.py REFINE_NORMAL_STEPS
constexpr int kGrangeSteps = 8;   // grange 1.0 in quarter-pixel steps
constexpr int kUnionSteps = kNormalSteps + kGrangeSteps;  // 33
constexpr int kUndistortIters = 25;
constexpr int kMaxEdgeThreads = 1024;  // an edge's block at most

// One camera: intrinsics and (k1, k2, p1, p2, k3).
struct Lens {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

// ((1 + k1 r2) + (k2 r2) r2) + ((k3 r2) r2) r2
RVT_REFINE_FN float radial(const Lens& l, float r2) {
  return add(add(add(1.0f, mul(l.k1, r2)), mul(mul(l.k2, r2), r2)),
             mul(mul(mul(l.k3, r2), r2), r2));
}

// ((2 p) x) y
RVT_REFINE_FN float cross_term(float p, float x, float y) {
  return mul(mul(mul(2.0f, p), x), y);
}

// p (r2 + (2 v) v)
RVT_REFINE_FN float square_term(float p, float r2, float v) {
  return mul(p, add(r2, mul(mul(2.0f, v), v)));
}

// decode.py _undistort: 25 fixed-point steps in normalised coordinates,
// unrolled by 5 on the card. A NaN point stays NaN through every step
// (each takes both coordinates), so it is returned at once: its divisions
// would take their slow path.
RVT_REFINE_FN void undistort(const Lens& l, float px, float py, float* ox,
                             float* oy) {
  if (px != px || py != py) {
    *ox = *oy = NAN;
    return;
  }
  const float x0 = dvd(sub(px, l.cx), l.fx);
  const float y0 = dvd(sub(py, l.cy), l.fy);
  float x = x0, y = y0;
#pragma unroll 5
  for (int it = 0; it < kUndistortIters; ++it) {
    const float r2 = add(mul(x, x), mul(y, y));
    const float rad = radial(l, r2);
    const float dx = add(cross_term(l.p1, x, y), square_term(l.p2, r2, x));
    const float dy = add(square_term(l.p1, r2, y), cross_term(l.p2, x, y));
    x = dvd(sub(x0, dx), rad);
    y = dvd(sub(y0, dy), rad);
  }
  *ox = add(mul(x, l.fx), l.cx);
  *oy = add(mul(y, l.fy), l.cy);
}

// decode.py _distort
RVT_REFINE_FN void distort(const Lens& l, float px, float py, float* ox,
                           float* oy) {
  const float x = dvd(sub(px, l.cx), l.fx);
  const float y = dvd(sub(py, l.cy), l.fy);
  const float r2 = add(mul(x, x), mul(y, y));
  const float rad = radial(l, r2);
  const float xd = add(add(mul(x, rad), cross_term(l.p1, x, y)),
                       square_term(l.p2, r2, x));
  const float yd = add(add(mul(y, rad), square_term(l.p1, r2, y)),
                       cross_term(l.p2, x, y));
  *ox = add(mul(xd, l.fx), l.cx);
  *oy = add(mul(yd, l.fy), l.cy);
}

// One edge a -> b of a quad (corner i to corner (i + 1) & 3): its unit
// normal, its sample count ns and its midpoint.
struct Edge {
  float ax, ay, bx, by, nx, ny, ns, emx, emy;
};

RVT_REFINE_FN Edge make_edge(float ax, float ay, float bx, float by,
                             int n_alpha) {
  Edge e;
  e.ax = ax;
  e.ay = ay;
  e.bx = bx;
  e.by = by;
  const float nx = sub(by, ay);
  const float ny = add(-bx, ax);
  const float mag = root(add(mul(nx, nx), mul(ny, ny)));
  const float mag_safe = mag == 0.0f ? 1e-6f : mag;
  e.nx = dvd(nx, mag_safe);
  e.ny = dvd(ny, mag_safe);
  // floor(mag / 8).clamp(16, n_alpha); torch's clamp passes NaN through
  const float f = floorf(mul(mag, 0.125f));
  e.ns = f != f ? f : fminf(fmaxf(f, 16.0f), (float)n_alpha);
  e.emx = mul(0.5f, add(ax, bx));
  e.emy = mul(0.5f, add(ay, by));
  return e;
}

// The edge point of sample s: alpha a + (1 - alpha) b.
RVT_REFINE_FN void sample_origin(const Edge& e, int s, float* x0, float* y0) {
  const float alpha = dvd(add(1.0f, (float)s), add(e.ns, 1.0f));
  const float beta = sub(1.0f, alpha);
  *x0 = add(mul(alpha, e.ax), mul(beta, e.bx));
  *y0 = add(mul(alpha, e.ay), mul(beta, e.by));
}

// A pixel of the normal ray's union of offsets -4 + u / 4, u in [0, 33):
// its position, whether it is in the frame, and its flat index there.
struct Sample {
  float px, py;
  bool ok;
  int idx;
};

RVT_REFINE_FN Sample union_sample(const Edge& e, float x0, float y0, int u,
                                  int h, int w) {
  const float off = add(-4.0f, mul(0.25f, (float)u));
  Sample p;
  p.px = add(x0, mul(off, e.nx));
  p.py = add(y0, mul(off, e.ny));
  p.ok = p.px >= 0.0f && p.py >= 0.0f && p.px < (float)w && p.py < (float)h;
  p.idx = p.ok ? (int)p.py * w + (int)p.px : 0;
  return p;
}

// The term of sample s at normal offset -3 + k / 4: its weight (the
// squared step across the edge where both rays' pixels are in the frame,
// the polarity holds and s < ns; else 0) and its point, undistorted when
// `have_dist`.
struct Term {
  float wgt, xo, yo;
};

RVT_REFINE_FN Term edge_term(const Edge& e, const uint8_t* gray, int h,
                             int w, int s, int k, const Lens& lens,
                             bool have_dist, bool reversed) {
  float x0, y0;
  sample_origin(e, s, &x0, &y0);
  const Sample s2 = union_sample(e, x0, y0, k, h, w);  // at n - grange
  const Sample s1 = union_sample(e, x0, y0, k + kGrangeSteps, h, w);
  const float g2 = s2.ok ? (float)gray[s2.idx] : 0.0f;
  const float g1 = s1.ok ? (float)gray[s1.idx] : 0.0f;
  const bool pol = reversed ? g2 >= g1 : g1 >= g2;
  const bool ok = s1.ok && s2.ok && pol && (float)s < e.ns;
  const float d = sub(g2, g1);
  Term t;
  t.wgt = ok ? mul(d, d) : 0.0f;
  const float n_off = add(-3.0f, mul(0.25f, (float)k));
  t.xo = add(x0, mul(n_off, e.nx));
  t.yo = add(y0, mul(n_off, e.ny));
  if (have_dist) undistort(lens, t.xo, t.yo, &t.xo, &t.yo);
  return t;
}

// Adds a term's six moments about the edge midpoint to m:
// w dx, w dy, (w dx) dx, (w dx) dy, (w dy) dy, w.
RVT_REFINE_FN void add_moments(const Edge& e, const Term& t, float m[6]) {
  const float xod = sub(t.xo, e.emx);
  const float yod = sub(t.yo, e.emy);
  const float wx = mul(t.wgt, xod);
  const float wy = mul(t.wgt, yod);
  m[0] = add(m[0], wx);
  m[1] = add(m[1], wy);
  m[2] = add(m[2], mul(wx, xod));
  m[3] = add(m[3], mul(wx, yod));
  m[4] = add(m[4], mul(wy, yod));
  m[5] = add(m[5], t.wgt);
}

// The terms of an edge's n_alpha-sample grid, term i = s * 25 + k.
RVT_REFINE_FN int edge_terms(int n_alpha) { return n_alpha * kNormalSteps; }

// The threads of an edge's block: one a term, in whole warps, at least
// two (refine.cu fits the line on both) and at most kMaxEdgeThreads (800
// at 32 samples; 1,024 at 64 and 128, so a thread takes at most 2 and 4
// terms there).
RVT_REFINE_FN int edge_threads(int n_alpha) {
  const int warps = (edge_terms(n_alpha) + 31) / 32;
  return warps < 2 ? 64
                   : warps < kMaxEdgeThreads / 32 ? warps * 32
                                                   : kMaxEdgeThreads;
}

// Thread t of `threads` takes the terms i = t + r * threads, r in
// [0, thread_terms), i ascending.
RVT_REFINE_FN int thread_terms(int n_alpha, int t, int threads) {
  const int n = edge_terms(n_alpha);
  return t < n ? (n - t + threads - 1) / threads : 0;
}

RVT_REFINE_FN int term_index(int t, int r, int threads) {
  return t + r * threads;
}

// Thread t's sums of its terms (see thread_terms): every term of the
// grid, masked ones too (they add w = 0 times the point, so a non-finite
// point poisons the sums as in the plain version).
RVT_REFINE_FN void thread_sums(const Edge& e, const uint8_t* gray, int h,
                               int w, int n_alpha, const Lens& lens,
                               bool have_dist, bool reversed, int t,
                               int threads, float m[6]) {
  for (int q = 0; q < 6; ++q) m[q] = 0.0f;
  const int n = thread_terms(n_alpha, t, threads);
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const int i = term_index(t, r, threads);
    add_moments(e, edge_term(e, gray, h, w, i / kNormalSteps,
                             i % kNormalSteps, lens, have_dist, reversed),
                m);
  }
}

// The fitted line of an edge: its centroid and direction, and whether any
// term had weight (usable).
struct Line {
  float ex, ey, lnx, lny;
  bool usable;
};

// The moments' divisor: their weight, or 1 where it is not above 1e-9
// (the line is then unusable).
RVT_REFINE_FN float moment_divisor(const float m[6]) {
  return m[5] > 1e-9f ? m[5] : 1.0f;
}

// The line's angle from the moments over their divisor, d[q] = m[q] / n:
// the covariance's principal direction.
RVT_REFINE_FN float line_angle(const float d[5]) {
  const float mx = d[0], my = d[1];
  const float cxx = sub(d[2], mul(mx, mx));
  const float cxy = sub(d[3], mul(mx, my));
  const float cyy = sub(d[4], mul(my, my));
  return mul(0.5f, atan2_f64(mul(-2.0f, cxy), sub(cyy, cxx)));
}

RVT_REFINE_FN Line fit_line(const Edge& e, const float m[6]) {
  const float n_safe = moment_divisor(m);
  float d[5];
  for (int q = 0; q < 5; ++q) d[q] = dvd(m[q], n_safe);
  const float theta = line_angle(d);
  return {add(d[0], e.emx), add(d[1], e.emy), cos_f64(theta),
          sin_f64(theta), m[5] > 1e-9f};
}

// Corner j = (i + 1) & 3 where the lines of edges i and j meet (distorted
// back when `have_dist`), or its input `in` where they are near parallel,
// either is unusable or the quad is not valid.
RVT_REFINE_FN void corner(const Line& li, const Line& lj, bool quad_valid,
                          const Lens& lens, bool have_dist, const float in[2],
                          float out[2]) {
  const float a00 = li.lny, a01 = -lj.lny;
  const float a10 = -li.lnx, a11 = lj.lnx;
  const float b0 = add(-li.ex, lj.ex);
  const float b1 = add(-li.ey, lj.ey);
  const float det = sub(mul(a00, a11), mul(a10, a01));
  const bool good = fabsf(det) > 1e-3f && li.usable && lj.usable &&
                    quad_valid;
  const float l0 = dvd(sub(mul(a11, b0), mul(a01, b1)),
                       det == 0.0f ? 1e-12f : det);
  float px = add(li.ex, mul(l0, a00));
  float py = add(li.ey, mul(l0, a10));
  if (have_dist) distort(lens, px, py, &px, &py);
  out[0] = good ? px : in[0];
  out[1] = good ? py : in[1];
}

}  // namespace rvt_refine
