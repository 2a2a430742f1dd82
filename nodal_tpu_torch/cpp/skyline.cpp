// Skyline (profile) LDL^T factorization of a symmetric positive definite
// system: the host-direct route of the resistive sparse solve
// (nodal_tpu_torch/ops/sparse.py) and of the multi-probe equivalent
// resistance (nodal_tpu_torch/equiv.py).  A copy of nodal_tpu's
// cpp/skyline.cpp, built and loaded by nodal_tpu_torch/ops/skyline.py.
//
// Role: the native direct solver in the place of the reference's SuperLU
// call (reference nodal/nodal.py:325).  The Python layer computes an RCM
// ordering, packs the lower-triangular profile ("skyline") of A, and
// calls sk_factor once per parameter vector; every later right-hand side
// is one O(profile) forward/backward sweep with no iteration.
//
// Storage layout (row-compressed lower profile):
//   jmin[i]           first nonzero column of row i (jmin[i] <= i)
//   rowptr[i]         start of row i's off-diagonal span in `sky`
//                     (length i - jmin[i]); rowptr[n] = total
//   sky[rowptr[i]+k]  L[i][jmin[i]+k]   (A values in, L values out)
//   diag[i]           A[i][i] in, D[i] out
//
// The factorization is the classic in-place skyline LDL^T: row i's
// entries are produced left to right, each as a dot product of two
// previously-computed row segments — contiguous memory, auto-vectorized.
// No pivoting: the grounded resistive system is SPD; a non-positive pivot
// signals the caller to take the Krylov route (return value = 1-based row
// of the bad pivot).

#include <cstdint>
#include <cmath>

extern "C" {

// Factor in place.  Returns 0 on success, i+1 when pivot D[i] is not
// strictly positive (caller falls back), -1 on bad arguments.
int64_t sk_factor(int64_t n, const int32_t* jmin, const int64_t* rowptr,
                  double* sky, double* diag) {
    if (n < 0) return -1;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ji = jmin[i];
        double* Li = sky + rowptr[i] - ji;  // Li[j] = L[i][j], j in [ji, i)
        // Off-diagonal entries of row i.
        for (int64_t j = ji; j < i; ++j) {
            const int64_t jj = jmin[j];
            const double* Lj = sky + rowptr[j] - jj;
            const int64_t k0 = ji > jj ? ji : jj;
            double s = Li[j];
            for (int64_t k = k0; k < j; ++k) s -= Li[k] * diag[k] * Lj[k];
            Li[j] = s / diag[j];
        }
        // Diagonal pivot.
        double d = diag[i];
        for (int64_t k = ji; k < i; ++k) d -= Li[k] * Li[k] * diag[k];
        if (!(d > 0.0) || !std::isfinite(d)) return i + 1;
        diag[i] = d;
    }
    return 0;
}

// Solve L D L^T x = b for `c` right-hand sides, in place.  X is [c, n]
// row-major (each row one RHS).  Safe to call concurrently on disjoint X.
void sk_solve(int64_t n, const int32_t* jmin, const int64_t* rowptr,
              const double* sky, const double* diag, double* X, int64_t c) {
#pragma omp parallel for schedule(static) if (c > 1)
    for (int64_t r = 0; r < c; ++r) {
        double* x = X + r * n;
        // Forward: y = L^{-1} b (unit lower triangular).
        for (int64_t i = 0; i < n; ++i) {
            const int64_t ji = jmin[i];
            const double* Li = sky + rowptr[i] - ji;
            double s = x[i];
            for (int64_t k = ji; k < i; ++k) s -= Li[k] * x[k];
            x[i] = s;
        }
        // Diagonal: z = D^{-1} y.
        for (int64_t i = 0; i < n; ++i) x[i] /= diag[i];
        // Backward: x = L^{-T} z (column saxpy order).
        for (int64_t i = n - 1; i >= 0; --i) {
            const int64_t ji = jmin[i];
            const double* Li = sky + rowptr[i] - ji;
            const double xi = x[i];
            for (int64_t k = ji; k < i; ++k) x[k] -= Li[k] * xi;
        }
    }
}

// Blocked multi-RHS solve: X is [c, n] row-major.  The per-RHS sweep in
// sk_solve re-streams the entire factor from RAM once per right-hand
// side (measured 0.26 GFLOP/s — pure memory-latency bound at 8192 RHS /
// 40k unknowns: 240 GB of L traffic).  Here a block of `cb` RHS is
// transposed to [n, cb] so the innermost loop runs contiguously over the
// RHS lane while each L entry is loaded ONCE per block — L traffic drops
// by cb× and the lane loop vectorizes (FMA over the CB = 32
// doubles of a block, sk_solve_blocked below).
}  // extern "C" (templates cannot carry C linkage)

template <int64_t CB>
static void sk_solve_block_fixed(int64_t n, const int32_t* jmin,
                                 const int64_t* rowptr, const double* sky,
                                 const double* diag, double* X, int64_t b0) {
    // Fixed-width lane loops: the compiler fully vectorizes/unrolls a
    // constant trip count where the runtime-cb version keeps a scalar
    // prologue/epilogue per L entry.
    double* Xt = new double[(size_t)n * CB];
    for (int64_t r = 0; r < CB; ++r)
        for (int64_t i = 0; i < n; ++i)
            Xt[i * CB + r] = X[(b0 + r) * n + i];
    for (int64_t i = 0; i < n; ++i) {
        const int64_t ji = jmin[i];
        const double* Li = sky + rowptr[i] - ji;
        double* xi = Xt + i * CB;
        for (int64_t k = ji; k < i; ++k) {
            const double lik = Li[k];
            const double* xk = Xt + k * CB;
            for (int64_t r = 0; r < CB; ++r) xi[r] -= lik * xk[r];
        }
    }
    for (int64_t i = 0; i < n; ++i) {
        const double di = diag[i];
        double* xi = Xt + i * CB;
        for (int64_t r = 0; r < CB; ++r) xi[r] /= di;
    }
    for (int64_t i = n - 1; i >= 0; --i) {
        const int64_t ji = jmin[i];
        const double* Li = sky + rowptr[i] - ji;
        const double* xi = Xt + i * CB;
        for (int64_t k = ji; k < i; ++k) {
            const double lik = Li[k];
            double* xk = Xt + k * CB;
            for (int64_t r = 0; r < CB; ++r) xk[r] -= lik * xi[r];
        }
    }
    for (int64_t r = 0; r < CB; ++r)
        for (int64_t i = 0; i < n; ++i)
            X[(b0 + r) * n + i] = Xt[i * CB + r];
    delete[] Xt;
}

extern "C" void sk_solve_blocked(int64_t n, const int32_t* jmin,
                                 const int64_t* rowptr, const double* sky,
                                 const double* diag, double* X,
                                 int64_t c) {
    const int64_t CB = 32;
#pragma omp parallel for schedule(static) if (c > CB)
    for (int64_t b0 = 0; b0 < c; b0 += CB) {
        const int64_t cb = (c - b0) < CB ? (c - b0) : CB;
        if (cb == CB) {
            sk_solve_block_fixed<CB>(n, jmin, rowptr, sky, diag, X, b0);
            continue;
        }
        double* Xt = new double[(size_t)n * cb];  // per-block scratch
        // Gather block, transposed: Xt[i*cb + r] = X[(b0+r)*n + i].
        for (int64_t r = 0; r < cb; ++r)
            for (int64_t i = 0; i < n; ++i)
                Xt[i * cb + r] = X[(b0 + r) * n + i];
        // Forward: y = L^{-1} b.
        for (int64_t i = 0; i < n; ++i) {
            const int64_t ji = jmin[i];
            const double* Li = sky + rowptr[i] - ji;
            double* xi = Xt + i * cb;
            for (int64_t k = ji; k < i; ++k) {
                const double lik = Li[k];
                const double* xk = Xt + k * cb;
                for (int64_t r = 0; r < cb; ++r) xi[r] -= lik * xk[r];
            }
        }
        // Diagonal.
        for (int64_t i = 0; i < n; ++i) {
            const double di = diag[i];
            double* xi = Xt + i * cb;
            for (int64_t r = 0; r < cb; ++r) xi[r] /= di;
        }
        // Backward: x = L^{-T} z.
        for (int64_t i = n - 1; i >= 0; --i) {
            const int64_t ji = jmin[i];
            const double* Li = sky + rowptr[i] - ji;
            const double* xi = Xt + i * cb;
            for (int64_t k = ji; k < i; ++k) {
                const double lik = Li[k];
                double* xk = Xt + k * cb;
                for (int64_t r = 0; r < cb; ++r) xk[r] -= lik * xi[r];
            }
        }
        // Scatter back.
        for (int64_t r = 0; r < cb; ++r)
            for (int64_t i = 0; i < n; ++i)
                X[(b0 + r) * n + i] = Xt[i * cb + r];
        delete[] Xt;
    }
}
