// K3's pair arithmetic: whether a pose pair passes both similarity
// gates of the RMSD prune (Kabsch rmsd < thr AND maximum per-atom
// deviation < 2*thr, no centering), operation by operation as
// csrc/qcp_kill.cu's note describes it. Shared by the pair kill K3
// (qcp_kill.cu) and the block sweep B1 (block_screen.cu), so both walk
// the same float64 operation order and give the same bits on a pair.

#pragma once

#include <cuda_runtime.h>

namespace qcpk {

template <typename T> struct NewtonSteps;
template <> struct NewtonSteps<float> { static constexpr int value = 12; };
template <> struct NewtonSteps<double> { static constexpr int value = 30; };

template <typename T>
__device__ __forceinline__ T det3(T a00, T a01, T a02, T a10, T a11, T a12,
                                  T a20, T a21, T a22) {
  return a00 * (a11 * a22 - a12 * a21) - a01 * (a10 * a22 - a12 * a20) +
         a02 * (a10 * a21 - a11 * a20);
}

// Does the pair (p, q) pass both similarity gates? N = NA when NA > 0.
template <typename T, int NA>
__device__ __forceinline__ bool pair_hits(const T* __restrict__ P,
                                          const T* __restrict__ Q, int n_rt,
                                          T GA, T thr, T two_thr, T sqrt_n) {
  const int N = NA > 0 ? NA : n_rt;
  T Sxx = 0, Sxy = 0, Sxz = 0, Syx = 0, Syy = 0, Syz = 0, Szx = 0, Szy = 0,
    Szz = 0, GB = 0;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const T px = P[3 * n], py = P[3 * n + 1], pz = P[3 * n + 2];
    const T qx = Q[3 * n], qy = Q[3 * n + 1], qz = Q[3 * n + 2];
    Sxx += px * qx; Sxy += px * qy; Sxz += px * qz;
    Syx += py * qx; Syy += py * qy; Syz += py * qz;
    Szx += pz * qx; Szy += pz * qy; Szz += pz * qz;
    GB += qx * qx + qy * qy + qz * qz;
  }

  // characteristic quartic of Horn's key matrix: x^4 + C2 x^2 + C1 x + C0
  const T Sxx2 = Sxx * Sxx, Syy2 = Syy * Syy, Szz2 = Szz * Szz;
  const T Sxy2 = Sxy * Sxy, Syz2 = Syz * Syz, Sxz2 = Sxz * Sxz;
  const T Syx2 = Syx * Syx, Szy2 = Szy * Szy, Szx2 = Szx * Szx;
  const T SyzSzymSyySzz2 = (T)2 * (Syz * Szy - Syy * Szz);
  const T Sxx2Syy2Szz2Syz2Szy2 = Syy2 + Szz2 - Sxx2 + Syz2 + Szy2;
  const T C2 = (T)-2 * (Sxx2 + Syy2 + Szz2 + Sxy2 + Syx2 + Sxz2 + Szx2 +
                        Syz2 + Szy2);
  const T C1 = (T)8 * (Sxx * Syz * Szy + Syy * Szx * Sxz + Szz * Sxy * Syx -
                       Sxx * Syy * Szz - Syz * Szx * Sxy - Szy * Syx * Sxz);
  const T SxzpSzx = Sxz + Szx, SyzpSzy = Syz + Szy, SxypSyx = Sxy + Syx;
  const T SyzmSzy = Syz - Szy, SxzmSzx = Sxz - Szx, SxymSyx = Sxy - Syx;
  const T SxxpSyy = Sxx + Syy, SxxmSyy = Sxx - Syy;
  const T Sxy2Sxz2Syx2Szx2 = Sxy2 + Sxz2 - Syx2 - Szx2;
  const T C0 =
      Sxy2Sxz2Syx2Szx2 * Sxy2Sxz2Syx2Szx2 +
      (Sxx2Syy2Szz2Syz2Szy2 + SyzSzymSyySzz2) *
          (Sxx2Syy2Szz2Syz2Szy2 - SyzSzymSyySzz2) +
      (-(SxzpSzx)*SyzmSzy + SxymSyx * (SxxmSyy - Szz)) *
          (-(SxzmSzx)*SyzpSzy + SxymSyx * (SxxmSyy + Szz)) +
      (-(SxzpSzx)*SyzpSzy - SxypSyx * (SxxpSyy - Szz)) *
          (-(SxzmSzx)*SyzmSzy - SxypSyx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzpSzy + SxzpSzx * (SxxmSyy + Szz)) *
          (-(SxymSyx)*SyzmSzy + SxzpSzx * (SxxpSyy + Szz)) +
      (SxypSyx * SyzmSzy + SxzmSzx * (SxxmSyy - Szz)) *
          (-(SxymSyx)*SyzpSzy + SxzmSzx * (SxxpSyy - Szz));

  T lam = (T)0.5 * (GA + GB);
#pragma unroll
  for (int it = 0; it < NewtonSteps<T>::value; ++it) {
    const T lam2 = lam * lam;
    const T b = (lam2 + C2) * lam;
    const T a = b + C1;
    const T num = a * lam + C0;
    T den = (T)2 * lam2 * lam + b + a;
    den = fabs(den) > (T)1e-30 ? den : (T)1e-30;
    lam = lam - num / den;
  }

  const T msd = (GA + GB - (T)2 * lam) / (T)N;
  const T rmsd = sqrt(msd > (T)0 ? msd : (T)0);
  if (!(rmsd < thr)) return false;
  if (N <= 4 || !(sqrt_n * rmsd >= two_thr)) return true;

  // ambiguous band: eigenvector of Horn's key matrix from the adjugate
  // of (K - lam I), first row of largest norm, identity if degenerate
  T A[4][4];
  A[0][0] = Sxx + Syy + Szz - lam; A[0][1] = Syz - Szy;
  A[0][2] = Szx - Sxz;             A[0][3] = Sxy - Syx;
  A[1][1] = Sxx - Syy - Szz - lam; A[1][2] = Sxy + Syx;
  A[1][3] = Szx + Sxz;
  A[2][2] = -Sxx + Syy - Szz - lam; A[2][3] = Syz + Szy;
  A[3][3] = -Sxx - Syy + Szz - lam;
  A[1][0] = A[0][1]; A[2][0] = A[0][2]; A[3][0] = A[0][3];
  A[2][1] = A[1][2]; A[3][1] = A[1][3]; A[3][2] = A[2][3];

  T best[4] = {0, 0, 0, 0};
  T best_n2 = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int r0 = r == 0 ? 1 : 0, r1 = r <= 1 ? 2 : 1, r2 = r <= 2 ? 3 : 2;
    T c[4];
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int c0 = col == 0 ? 1 : 0, c1 = col <= 1 ? 2 : 1,
                c2 = col <= 2 ? 3 : 2;
      const T m = det3(A[r0][c0], A[r0][c1], A[r0][c2], A[r1][c0], A[r1][c1],
                       A[r1][c2], A[r2][c0], A[r2][c1], A[r2][c2]);
      c[col] = ((r + col) & 1) ? -m : m;
    }
    const T n2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + c[3] * c[3];
    if (r == 0 || n2 > best_n2) {
      best[0] = c[0]; best[1] = c[1]; best[2] = c[2]; best[3] = c[3];
      best_n2 = n2;
    }
  }
  T qw = 1, qx = 0, qy = 0, qz = 0;
  if (best_n2 > (T)1e-22) {
    const T s = sqrt(best_n2 > (T)1e-30 ? best_n2 : (T)1e-30);
    qw = best[0] / s; qx = best[1] / s;
    qy = best[2] / s; qz = best[3] / s;
  }
  const T R00 = (T)2 * (qw * qw + qx * qx) - (T)1;
  const T R01 = (T)2 * (qx * qy - qw * qz);
  const T R02 = (T)2 * (qx * qz + qw * qy);
  const T R10 = (T)2 * (qx * qy + qw * qz);
  const T R11 = (T)2 * (qw * qw + qy * qy) - (T)1;
  const T R12 = (T)2 * (qy * qz - qw * qx);
  const T R20 = (T)2 * (qx * qz - qw * qy);
  const T R21 = (T)2 * (qy * qz + qw * qx);
  const T R22 = (T)2 * (qw * qw + qz * qz) - (T)1;

  T maxdev2 = 0;
  for (int n = 0; n < N; ++n) {
    const T px = P[3 * n], py = P[3 * n + 1], pz = P[3 * n + 2];
    const T dx = R00 * px + R01 * py + R02 * pz - Q[3 * n];
    const T dy = R10 * px + R11 * py + R12 * pz - Q[3 * n + 1];
    const T dz = R20 * px + R21 * py + R22 * pz - Q[3 * n + 2];
    const T d2 = dx * dx + dy * dy + dz * dz;
    maxdev2 = d2 > maxdev2 ? d2 : maxdev2;
  }
  return sqrt(maxdev2) < two_thr;
}

// squared norm of a row, summed element by element
template <typename T, int NA>
__device__ __forceinline__ T row_norm2(const T* P, int stride) {
  const int S3 = NA > 0 ? 3 * NA : stride;
  T G = 0;
#pragma unroll
  for (int i = 0; i < S3; ++i) G += P[i] * P[i];
  return G;
}

}  // namespace qcpk
