// The pose of one quad slot: ops/pose.py estimate_poses_plain for one
// (b, q). Included by pose.cu; it also compiles as plain C++ (no CUDA
// header), so that the same arithmetic can be built by a host compiler
// (with -ffp-contract=off) and held against the plain version on the CPU.
//
// Two forms of the same arithmetic: estimate_slot, one thread's serial
// computation with its state in registers (the reference), and
// estimate_slot_lanes, the kernel's, which spreads each Newton polar step
// over a slot's lanes (a lane per entry of the polar iterate X) and each
// orthogonal-iteration step's data columns and their norms (a lane per
// entry).
// A lane form takes the values other lanes computed through an exchange
// `Lanes` (pose.cu's shuffles on the card; an array a host build fills by
// running the lanes one after another), and every value keeps the serial
// form's operands and order, so the two give the same bits.
//
// Order of operations: the plain version's, entry for entry: each 3x3
// product and sum is taken left to right over its terms, as torch sums a
// 3-term last axis. The sums over more than one axis (the 12-term
// sum_n (vv_n - I) rp_n, the 9-term norm of the polar start and the 12-term
// error) have torch's own order, which is not specified; here they go n
// outer, then the row's terms. Each f32 operation rounds once: on the card
// through the __f*_rn intrinsics, which nvcc never contracts into an FMA
// (its default -fmad=true would, and NVCC_FLAGS stay as boundary.cu needs
// them). atan2, sin and cos are evaluated in f64 and rounded to f32, as
// ops/mathf.py does it: the f32 library versions differ between the card
// and the CPU in the last place.
//
// Non-finite inputs: every clamp is written `x < lo ? lo : x`, so a NaN
// passes through as torch's clamp_min and torch.where(x < lo, lo, x) pass
// it, and an all-zero or NaN homography gives NaN everywhere, as the plain
// version does.
#pragma once
#include <math.h>

#if defined(__CUDACC__)
#define RVT_POSE_FN __host__ __device__ __forceinline__
// the lane forms call the card's exchange, which has no host side
#define RVT_LANE_FN __device__ __forceinline__
#else
#define RVT_POSE_FN inline
#define RVT_LANE_FN inline
#endif

namespace rvt_pose {

RVT_POSE_FN float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

RVT_POSE_FN float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

RVT_POSE_FN float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

RVT_POSE_FN float dvd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

RVT_POSE_FN float root(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return sqrtf(a);
#endif
}

// torch.clamp_min(x, lo): NaN stays NaN
RVT_POSE_FN float at_least(float x, float lo) { return x < lo ? lo : x; }

// (a0 b0 + a1 b1) + a2 b2
RVT_POSE_FN float dot3(const float a[3], const float b[3]) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

// component j of torch.linalg.cross(a, b), in its order
RVT_POSE_FN float cross_at(float a1, float b2, float a2, float b1) {
  return sub(mul(a1, b2), mul(a2, b1));
}

RVT_POSE_FN void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = cross_at(a[1], b[2], a[2], b[1]);
  c[1] = cross_at(a[2], b[0], a[0], b[2]);
  c[2] = cross_at(a[0], b[1], a[1], b[0]);
}

// rows r1 x r2, r2 x r0, r0 x r1 (pose.py _cofactor): adj(m) = c^T,
// det(m) = m[0] . c[0]
RVT_POSE_FN void cofactor(const float m[3][3], float c[3][3]) {
  cross3(m[1], m[2], c[0]);
  cross3(m[2], m[0], c[1]);
  cross3(m[0], m[1], c[2]);
}

// pose.py _safe_det's clamp
RVT_POSE_FN float safe(float det) { return fabsf(det) < 1e-20f ? 1e-20f : det; }

// pose.py _safe_det
RVT_POSE_FN float safe_det(const float m[3][3], const float c[3][3]) {
  return safe(dot3(m[0], c[0]));
}

// the polar rotation's start: m's RMS entry, at least 1e-20
RVT_POSE_FN float rms_entry(const float m[3][3]) {
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s2 = add(s2, mul(m[i][j], m[i][j]));
  const float nrm = root(dvd(s2, 3.0f));
  return nrm < 1e-20f ? 1e-20f : nrm;
}

// One Newton step's entry of X: (x + c / det) / 2
RVT_POSE_FN float newton_entry(float x, float c, float det) {
  return mul(0.5f, add(x, dvd(c, det)));
}

// pose.py polar_rotation: 8 Newton steps X <- (X + X^-T) / 2 from m scaled
// to unit RMS entry, then the z-column flip where det < 0; in place.
RVT_POSE_FN void polar_rotation(float x[3][3]) {
  const float den = rms_entry(x);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) x[i][j] = dvd(x[i][j], den);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    float c[3][3];
    cofactor(x, c);
    const float det = safe_det(x, c);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) x[i][j] = newton_entry(x[i][j], c[i][j], det);
  }
  float c0[3];
  cross3(x[1], x[2], c0);
  if (dot3(x[0], c0) < 0.0f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i][2] = mul(x[i][2], -1.0f);
  }
}

// The sight rays' projectors vv_n = v_n v_n^T / |v_n|^2 (symmetric: the
// six entries i <= j of each) and G = inv3(I - mean_n vv_n) / 4, which both
// orthogonal iterations share.
struct Rays {
  float vv[4][6];
  float g[3][3];
};

RVT_POSE_FN int sym(int i, int j) {
  return i <= j ? i * 3 - (i * (i - 1)) / 2 + (j - i)
                : j * 3 - (j * (j - 1)) / 2 + (i - j);
}

RVT_POSE_FN void make_rays(const float v[4][3], Rays& r) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float nn = dot3(v[n], v[n]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j)
        r.vv[n][sym(i, j)] = dvd(mul(v[n][i], v[n][j]), nn);
  }
  float a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = sym(i, j);
      const float mean = dvd(
          add(add(add(r.vv[0][k], r.vv[1][k]), r.vv[2][k]), r.vv[3][k]),
          4.0f);
      a[i][j] = sub(i == j ? 1.0f : 0.0f, mean);
    }
  float c[3][3];
  cofactor(a, c);
  const float det = safe_det(a, c);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.g[i][j] = dvd(dvd(c[j][i], det), 4.0f);
}

// The planar tag corners (-s, s), (s, s), (s, -s), (-s, -s), z = 0.
RVT_POSE_FN float obj_x(int n, float s) { return (n == 0 || n == 3) ? -s : s; }
RVT_POSE_FN float obj_y(int n, float s) { return n < 2 ? s : -s; }

// row . (ox, oy, 0), the zero z term included (an inf in r's third column
// gives NaN there, as the plain version's product does)
RVT_POSE_FN float rotated(float r0, float r1, float r2, float ox, float oy) {
  return add(add(mul(r0, ox), mul(r1, oy)), mul(r2, 0.0f));
}

// r @ obj_n
RVT_POSE_FN void rotate_corners(const float r[3][3], float s, float rp[4][3]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rp[n][i] = rotated(r[i][0], r[i][1], r[i][2], obj_x(n, s), obj_y(n, s));
}

// vv_n @ p
RVT_POSE_FN void project_ray(const Rays& ry, int n, const float p[3],
                             float q[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float row[3] = {ry.vv[n][sym(i, 0)], ry.vv[n][sym(i, 1)],
                          ry.vv[n][sym(i, 2)]};
    q[i] = dot3(row, p);
  }
}

// An orthogonal-iteration step's translation: w = sum_n (vv_n - I) rp_n;
// t = G w
RVT_POSE_FN void step_translation(const Rays& ry, const float rp[4][3],
                                  float t[3]) {
  float w[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float e = i == j ? sub(ry.vv[n][sym(i, j)], 1.0f)
                               : ry.vv[n][sym(i, j)];
        w[i] = add(w[i], mul(e, rp[n][j]));
      }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = dot3(ry.g[i], w);
}

// An orthogonal-iteration step's rotation before its polar factor, from
// the projected corners q_n = vv_n (rp_n + t): the two data columns of
// m = sum_n (q_n - mean q) obj_n^T, and their cross product scaled to the
// columns' geometric-mean norm.
RVT_POSE_FN void polar_input(const float q[4][3], float s, float m[3][3]) {
  float c0[3], c1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float qm =
        dvd(add(add(add(q[0][i], q[1][i]), q[2][i]), q[3][i]), 4.0f);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float d = sub(q[n][i], qm);
      a0 = n == 0 ? mul(d, obj_x(n, s)) : add(a0, mul(d, obj_x(n, s)));
      a1 = n == 0 ? mul(d, obj_y(n, s)) : add(a1, mul(d, obj_y(n, s)));
    }
    c0[i] = a0;
    c1[i] = a1;
  }
  float c2[3];
  cross3(c0, c1, c2);
  const float n0 = root(dot3(c0, c0));
  const float n1 = root(dot3(c1, c1));
  const float c2n = root(dot3(c2, c2));
  const float scale = dvd(root(mul(n0, n1)), at_least(c2n, 1e-30f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i][0] = c0[i];
    m[i][1] = c1[i];
    m[i][2] = mul(c2[i], scale);
  }
}

// The projected corners q_n = vv_n (rp_n + t)
RVT_POSE_FN void project_corners(const Rays& ry, const float rp[4][3],
                                 const float t[3], float q[4][3]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float p[3] = {add(rp[n][0], t[0]), add(rp[n][1], t[1]),
                        add(rp[n][2], t[2])};
    project_ray(ry, n, p, q[n]);
  }
}

// The object-space error of (r, t): sum_n |(I - vv_n)(r obj_n + t)|^2
RVT_POSE_FN float object_error(const Rays& ry, float s, const float r[3][3],
                               const float t[3]) {
  float rp[4][3];
  rotate_corners(r, s, rp);
  float err = 0.0f;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float p[3] = {add(rp[n][0], t[0]), add(rp[n][1], t[1]),
                        add(rp[n][2], t[2])};
    float q[3];
    project_ray(ry, n, p, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float res = sub(p[i], q[i]);
      err = add(err, mul(res, res));
    }
  }
  return err;
}

// pose.py _orthogonal_iteration from (r, t), n_steps steps, in place;
// returns the object-space error.
RVT_POSE_FN float orthogonal_iteration(const Rays& ry, float s, float r[3][3],
                                       float t[3], int n_steps) {
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    float rp[4][3], q[4][3];
    rotate_corners(r, s, rp);
    step_translation(ry, rp, t);
    project_corners(ry, rp, t, q);
    polar_input(q, s, r);
    polar_rotation(r);
  }
  return object_error(ry, s, r, t);
}

// pose.py _homography_init before its polar rotation, with t scaled by s
RVT_POSE_FN void homography_start(const float h[9], float fx, float fy,
                                  float cx, float cy, float s, float r[3][3],
                                  float t[3]) {
  const float r20 = h[6], r21 = h[7], tz = h[8];
  const float r00 = dvd(sub(h[0], mul(cx, r20)), fx);
  const float r01 = dvd(sub(h[1], mul(cx, r21)), fx);
  const float tx = dvd(sub(h[2], mul(cx, tz)), fx);
  const float r10 = dvd(sub(h[3], mul(cy, r20)), fy);
  const float r11 = dvd(sub(h[4], mul(cy, r21)), fy);
  const float ty = dvd(sub(h[5], mul(cy, tz)), fy);
  const float l1 =
      root(add(add(mul(r00, r00), mul(r10, r10)), mul(r20, r20)));
  const float l2 =
      root(add(add(mul(r01, r01), mul(r11, r11)), mul(r21, r21)));
  float k = dvd(1.0f, root(at_least(mul(l1, l2), 1e-12f)));
  k = tz < 0.0f ? -k : k;
  const float c0[3] = {mul(r00, k), mul(r10, k), mul(r20, k)};
  const float c1[3] = {mul(r01, k), mul(r11, k), mul(r21, k)};
  float c2[3];
  cross3(c0, c1, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[i][0] = c0[i];
    r[i][1] = c1[i];
    r[i][2] = c2[i];
  }
  t[0] = mul(mul(tx, k), s);
  t[1] = mul(mul(ty, k), s);
  t[2] = mul(mul(tz, k), s);
}

// f64 library functions rounded to f32 (ops/mathf.py)
RVT_POSE_FN float atan2_f64(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
RVT_POSE_FN float sin_f64(float a) { return (float)sin((double)a); }
RVT_POSE_FN float cos_f64(float a) { return (float)cos((double)a); }

RVT_POSE_FN float norm3(const float a[3]) { return root(dot3(a, a)); }

// The detection corners from H and their sight rays; whether every ray
// is finite.
RVT_POSE_FN bool sight_rays(const float h[9], float fx, float fy, float cx,
                            float cy, float v[4][3]) {
  bool finite = true;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float tx = (n == 0 || n == 3) ? -1.0f : 1.0f;
    const float ty = n < 2 ? 1.0f : -1.0f;
    const float z = add(add(mul(h[6], tx), mul(h[7], ty)), h[8]);
    const float px = dvd(add(add(mul(h[0], tx), mul(h[1], ty)), h[2]), z);
    const float py = dvd(add(add(mul(h[3], tx), mul(h[4], ty)), h[5]), z);
    v[n][0] = dvd(sub(px, cx), fx);
    v[n][1] = dvd(sub(py, cy), fy);
    v[n][2] = 1.0f;
    finite = finite && isfinite(v[n][0]) && isfinite(v[n][1]);
  }
  return finite;
}

// The planar ambiguity's second candidate: r1's tilt mirrored about the
// sight line t1; returns sin of the angle between them.
RVT_POSE_FN float mirrored(const float r1[3][3], const float t1[3],
                           float r2[3][3]) {
  const float tnn = at_least(norm3(t1), 1e-9f);
  const float tn[3] = {dvd(t1[0], tnn), dvd(t1[1], tnn), dvd(t1[2], tnn)};
  const float normal[3] = {r1[0][2], r1[1][2], r1[2][2]};
  float axis[3];
  cross3(tn, normal, axis);
  const float sin_a = norm3(axis);
  const float cos_a = dot3(tn, normal);
  const float ang = mul(-2.0f, atan2_f64(sin_a, cos_a));
  const float an = at_least(sin_a, 1e-9f);
  const float x = dvd(axis[0], an), y = dvd(axis[1], an),
              z = dvd(axis[2], an);
  const float kk[3][3] = {{0.0f, -z, y}, {z, 0.0f, -x}, {-y, x, 0.0f}};
  const float sn = sin_f64(ang);
  const float cn = sub(1.0f, cos_f64(ang));
  float rot[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float k2 = add(add(mul(kk[i][0], kk[0][k]), mul(kk[i][1], kk[1][k])),
                           mul(kk[i][2], kk[2][k]));
      rot[i][k] = add(add(i == k ? 1.0f : 0.0f, mul(sn, kk[i][k])),
                      mul(cn, k2));
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r2[i][k] = add(add(mul(rot[i][0], r1[0][k]), mul(rot[i][1], r1[1][k])),
                     mul(rot[i][2], r1[2][k]));
  return sin_a;
}

// One slot, serially: h (9, row-major) -> r (9), t (3), *err.
RVT_POSE_FN void estimate_slot(const float h[9], float fx, float fy, float cx,
                               float cy, float tag_size, int n_steps,
                               float r_out[9], float t_out[3],
                               float* err_out) {
  const float s = mul(tag_size, 0.5f);
  float v[4][3];
  // A non-finite ray (an all-zero or NaN homography) makes every
  // projector, G and so every output of a step NaN: write that at once,
  // as the plain version ends (its homography start survives only when
  // no step runs). The slot then takes no slow path of the divisions.
  if (!sight_rays(h, fx, fy, cx, cy, v) && n_steps > 0) {
    const float nan = NAN;
#pragma unroll
    for (int k = 0; k < 9; ++k) r_out[k] = nan;
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[k] = nan;
    *err_out = nan;
    return;
  }
  Rays ry;
  make_rays(v, ry);

  float r1[3][3], t1[3];
  homography_start(h, fx, fy, cx, cy, s, r1, t1);
  polar_rotation(r1);
  const float e1 = orthogonal_iteration(ry, s, r1, t1, n_steps);

  float r2[3][3], t2[3] = {t1[0], t1[1], t1[2]};
  const float sin_a = mirrored(r1, t1, r2);
  const float e2 = orthogonal_iteration(ry, s, r2, t2, n_steps);

  const bool use2 = (e2 < e1) && (sin_a > 1e-8f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) r_out[i * 3 + k] = use2 ? r2[i][k] : r1[i][k];
    t_out[i] = use2 ? t2[i] : t1[i];
  }
  *err_out = use2 ? e2 : e1;
}

// ---------------------------------------------------------------------
// The lane form. A slot runs on kSlotLanes lanes (a warp on the card),
// each holding the slot's state (r, t, the rays) whole; the work that the
// serial form does one entry after another with a division or a square
// root each is spread over the lanes, one entry a lane, and exchanged. A
// lane quantity (Lanes::Q) holds one value a lane: entry k of the polar
// iterate X on lane k (9 roles), entry (col, i) of a step's data columns
// on lane 3 col + i (6 roles), the norm of column k on lane k (3 roles).
// The exchange:
//   ln.each(n, f)  the quantity whose lane k holds f(k), for n roles (a
//                  lane past n - 1 takes role n - 1 and computes its value
//                  again, so that every lane runs the same code);
//   ln.at(q, k)    lane k's value of q (a shuffle on the card: every lane
//                  of the slot calls it, in straight-line code);
//   ln.own(q, k)   the calling lane's value of q, inside an each of the
//                  same roles (k is its role);
//   ln.mark(p)     the end of a phase p (pose.cu's timing build counts
//                  the cycles since the last mark; elsewhere it is empty).
// What every lane computes from what at() returns it computes in the
// serial form's order, so every lane holds the same bits.

constexpr int kSlotLanes = 32;

// entry k of a without indexing a at run time, so that a stays in
// registers on the card
RVT_POSE_FN float pick3(const float a[3], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : a[2];
}

template <class L, class Q>
RVT_LANE_FN void gather9(const L& ln, const Q& x, float m[3][3]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k / 3][k % 3] = ln.at(x, k);
}

// A Newton polar step, lane e = (i, j) of X: its cofactor entry from rows
// i + 1 and i + 2 (cofactor()'s rows, cross3's order), det = X[0] . c[0]
// taken by every lane from the whole of X, then one division.
template <class L>
RVT_LANE_FN typename L::Q newton_lanes(const L& ln, const typename L::Q& x) {
  float m[3][3];
  gather9(ln, x, m);
  float c0[3];
  cross3(m[1], m[2], c0);
  const float det = safe(dot3(m[0], c0));
  return ln.each(9, [&](int e) {
    const int i = e / 3, j = e % 3;
    const int a = 3 * ((i + 1) % 3), b = 3 * ((i + 2) % 3);
    const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
    const float c = cross_at(ln.at(x, a + j1), ln.at(x, b + j2),
                             ln.at(x, a + j2), ln.at(x, b + j1));
    return newton_entry(ln.own(x, e), c, det);
  });
}

// polar_rotation of m -> x, both held whole by every lane; X spread over
// 9 lanes for the Newton steps. The 8 steps are unrolled (the kernel then
// takes 95 registers and spills none, and a step's chain does not wait on
// the loop's branch); the orthogonal iteration's 50 steps stay rolled.
template <class L>
RVT_LANE_FN void polar_lanes(const L& ln, const float m[3][3],
                             float x[3][3]) {
  const float den = rms_entry(m);
  typename L::Q xq = ln.each(9, [&](int e) {
    const int i = e / 3, j = e % 3;
    const float col[3] = {pick3(m[0], j), pick3(m[1], j), pick3(m[2], j)};
    return dvd(pick3(col, i), den);
  });
  ln.mark(2);
#pragma unroll
  for (int it = 0; it < 8; ++it) xq = newton_lanes(ln, xq);
  ln.mark(3);
  gather9(ln, xq, x);
  float c0[3];
  cross3(x[1], x[2], c0);
  if (dot3(x[0], c0) < 0.0f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i][2] = mul(x[i][2], -1.0f);
  }
  ln.mark(4);
}

// polar_input on lanes: lane (col, i) of 6 forms data column col's entry i
// (one division a lane, where the serial form takes three in a row), lane
// k of 3 the norm of column k (one square root a lane); every lane takes
// the rest from them.
template <class L>
RVT_LANE_FN void polar_input_lanes(const L& ln, const float q[4][3], float s,
                                   float m[3][3]) {
  const typename L::Q cc = ln.each(6, [&](int k) {
    const int col = k / 3, i = k % 3;
    const float qn[4] = {pick3(q[0], i), pick3(q[1], i), pick3(q[2], i),
                         pick3(q[3], i)};
    const float qm =
        dvd(add(add(add(qn[0], qn[1]), qn[2]), qn[3]), 4.0f);
    float a = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float d =
          mul(sub(qn[n], qm), col == 0 ? obj_x(n, s) : obj_y(n, s));
      a = n == 0 ? d : add(a, d);
    }
    return a;
  });
  float c0[3], c1[3], c2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c0[i] = ln.at(cc, i);
    c1[i] = ln.at(cc, 3 + i);
  }
  cross3(c0, c1, c2);
  const typename L::Q norms = ln.each(3, [&](int k) {
    float v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = k == 0 ? c0[j] : k == 1 ? c1[j] : c2[j];
    return root(dot3(v, v));
  });
  const float n0 = ln.at(norms, 0), n1 = ln.at(norms, 1);
  const float scale =
      dvd(root(mul(n0, n1)), at_least(ln.at(norms, 2), 1e-30f));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i][0] = c0[i];
    m[i][1] = c1[i];
    m[i][2] = mul(c2[i], scale);
  }
}

// orthogonal_iteration with its polar input and polar rotation on lanes
template <class L>
RVT_LANE_FN float orthogonal_lanes(const L& ln, const Rays& ry, float s,
                                   float r[3][3], float t[3], int n_steps) {
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    ln.mark(5);
    float rp[4][3], q[4][3], m[3][3];
    rotate_corners(r, s, rp);
    step_translation(ry, rp, t);
    ln.mark(0);
    project_corners(ry, rp, t, q);
    polar_input_lanes(ln, q, s, m);
    ln.mark(1);
    polar_lanes(ln, m, r);
  }
  return object_error(ry, s, r, t);
}

// estimate_slot on a slot's lanes, every lane writing the whole result
// (r_out, t_out, *err_out). false where a sight ray is not finite and
// steps run: the caller writes NaN, as estimate_slot does (every lane of
// the slot returns there).
template <class L>
RVT_LANE_FN bool estimate_slot_lanes(const L& ln, const float h[9], float fx,
                                     float fy, float cx, float cy,
                                     float tag_size, int n_steps,
                                     float r_out[9], float t_out[3],
                                     float* err_out) {
  const float s = mul(tag_size, 0.5f);
  float v[4][3];
  if (!sight_rays(h, fx, fy, cx, cy, v) && n_steps > 0) return false;
  Rays ry;
  make_rays(v, ry);

  float m[3][3], r1[3][3], t1[3];
  homography_start(h, fx, fy, cx, cy, s, m, t1);
  polar_lanes(ln, m, r1);
  const float e1 = orthogonal_lanes(ln, ry, s, r1, t1, n_steps);

  float r2[3][3], t2[3] = {t1[0], t1[1], t1[2]};
  const float sin_a = mirrored(r1, t1, r2);
  const float e2 = orthogonal_lanes(ln, ry, s, r2, t2, n_steps);

  const bool use2 = (e2 < e1) && (sin_a > 1e-8f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) r_out[i * 3 + k] = use2 ? r2[i][k] : r1[i][k];
    t_out[i] = use2 ? t2[i] : t1[i];
  }
  *err_out = use2 ? e2 : e1;
  return true;
}

}  // namespace rvt_pose
