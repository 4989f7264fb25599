// The pose of one quad slot: ops/pose.py estimate_poses_plain for one
// (b, q), with its state in registers. Included by pose.cu; it also
// compiles as plain C++ (no CUDA header), so that the same arithmetic can
// be built by a host compiler (with -ffp-contract=off) and held against the
// plain version on the CPU.
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
#else
#define RVT_POSE_FN inline
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

// torch.linalg.cross's order
RVT_POSE_FN void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// rows r1 x r2, r2 x r0, r0 x r1 (pose.py _cofactor): adj(m) = c^T,
// det(m) = m[0] . c[0]
RVT_POSE_FN void cofactor(const float m[3][3], float c[3][3]) {
  cross3(m[1], m[2], c[0]);
  cross3(m[2], m[0], c[1]);
  cross3(m[0], m[1], c[2]);
}

// pose.py _safe_det
RVT_POSE_FN float safe_det(const float m[3][3], const float c[3][3]) {
  const float det = dot3(m[0], c[0]);
  return fabsf(det) < 1e-20f ? 1e-20f : det;
}

// pose.py polar_rotation: 8 Newton steps X <- (X + X^-T) / 2 from m scaled
// to unit RMS entry, then the z-column flip where det < 0; in place.
RVT_POSE_FN void polar_rotation(float x[3][3]) {
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s2 = add(s2, mul(x[i][j], x[i][j]));
  const float nrm = root(dvd(s2, 3.0f));
  const float den = nrm < 1e-20f ? 1e-20f : nrm;
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
      for (int j = 0; j < 3; ++j)
        x[i][j] = mul(0.5f, add(x[i][j], dvd(c[i][j], det)));
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

// r @ obj_n, the zero z term included (an inf in r's third column gives NaN
// there, as the plain version's product does)
RVT_POSE_FN void rotate_corners(const float r[3][3], float s, float rp[4][3]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rp[n][i] = add(add(mul(r[i][0], obj_x(n, s)), mul(r[i][1], obj_y(n, s))),
                     mul(r[i][2], 0.0f));
}

// vv_n @ p
RVT_POSE_FN void project_ray(const Rays& ry, int n, const float p[3],
                             float q[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = add(add(mul(ry.vv[n][sym(i, 0)], p[0]),
                   mul(ry.vv[n][sym(i, 1)], p[1])),
               mul(ry.vv[n][sym(i, 2)], p[2]));
}

// pose.py _orthogonal_iteration from (r, t), n_steps steps, in place;
// returns the object-space error.
RVT_POSE_FN float orthogonal_iteration(const Rays& ry, float s, float r[3][3],
                                       float t[3], int n_steps) {
#pragma unroll 1
  for (int step = 0; step < n_steps; ++step) {
    float rp[4][3];
    rotate_corners(r, s, rp);
    // w = sum_n (vv_n - I) rp_n; t = G w
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
    for (int i = 0; i < 3; ++i)
      t[i] = add(add(mul(ry.g[i][0], w[0]), mul(ry.g[i][1], w[1])),
                 mul(ry.g[i][2], w[2]));
    // q_n = vv_n (rp_n + t), centred
    float q[4][3];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float p[3] = {add(rp[n][0], t[0]), add(rp[n][1], t[1]),
                          add(rp[n][2], t[2])};
      project_ray(ry, n, p, q[n]);
    }
    // m = sum_n (q_n - mean q) obj_n^T: its two data columns
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
    // the third column: c0 x c1 scaled to the data columns' geometric-mean
    // norm
    float c2[3];
    cross3(c0, c1, c2);
    const float n0 = root(dot3(c0, c0));
    const float n1 = root(dot3(c1, c1));
    const float c2n = root(dot3(c2, c2));
    const float scale = dvd(root(mul(n0, n1)), at_least(c2n, 1e-30f));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      r[i][0] = c0[i];
      r[i][1] = c1[i];
      r[i][2] = mul(c2[i], scale);
    }
    polar_rotation(r);
  }
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

// pose.py _homography_init, with t scaled by s
RVT_POSE_FN void homography_init(const float h[9], float fx, float fy,
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
  polar_rotation(r);
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

// One slot: h (9, row-major) -> r (9), t (3), *err.
RVT_POSE_FN void estimate_slot(const float h[9], float fx, float fy, float cx,
                               float cy, float tag_size, int n_steps,
                               float r_out[9], float t_out[3],
                               float* err_out) {
  const float s = mul(tag_size, 0.5f);
  // the detection corners from H, and their sight rays
  float v[4][3];
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
  }
  // A non-finite ray (an all-zero or NaN homography) makes every
  // projector, G and so every output of a step NaN: write that at once,
  // as the plain version ends (its homography start survives only when
  // no step runs). The slot then takes no slow path of the divisions.
  bool finite = true;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    finite = finite && isfinite(v[n][0]) && isfinite(v[n][1]);
  if (!finite && n_steps > 0) {
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
  homography_init(h, fx, fy, cx, cy, s, r1, t1);
  const float e1 = orthogonal_iteration(ry, s, r1, t1, n_steps);

  // the planar ambiguity's second candidate: mirror the tilt about the
  // sight line
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
  float r2[3][3], t2[3] = {t1[0], t1[1], t1[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r2[i][k] = add(add(mul(rot[i][0], r1[0][k]), mul(rot[i][1], r1[1][k])),
                     mul(rot[i][2], r1[2][k]));
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

}  // namespace rvt_pose
