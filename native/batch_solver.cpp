// Native batched LDP dual active-set solver (C++17, OpenMP).
//
// The CPU-serving runtime of the framework: solves a batch of condensed-QP
// instances (shared problem arrays, per-instance parameter theta) with one
// worker thread per hardware core. Plays the role the external libdaqp C
// solver plays for the reference (SURVEY.md N1) but is an original,
// batch-first implementation of the same dual active-set method as the
// framework's device solver (ops/dual_active_set.py): index-based working set,
// per-iteration dense Cholesky of the active Gram block, signed multipliers
// for double-sided rows, per-row proximal soft weights, equality and
// immutable senses.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libbatchsolver.so batch_solver.cpp
// (omit -fopenmp for a single-threaded build; the pragma degrades cleanly)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

typedef struct {
    int m;        // constraint rows
    int n;        // decision variables
    int nth;      // parameter dimension
    int nu;       // controls to recover (leading rows of U)
    const double* G;        // (m, m) row-major normalized dual Gram
    const double* Dth;      // (m, nth)
    const double* du;       // (m,)
    const double* dl;       // (m,)
    const double* HinvET;   // (n, m)
    const double* Uth_off;  // (n, nth)
    const double* u_off;    // (n,)
    const int* is_eq;       // (m,)
    const int* is_immutable;// (m,)
    const double* rho;      // (m,) per-row proximal soft weight
    int iter_limit;
    double primal_tol;
    double sign_tol;
} lmpc_problem;

}  // extern "C"

namespace {

struct Workspace {
    std::vector<double> du_t, dl_t, lam, chol, rhs, lam_ws;
    std::vector<int> ws, side;
    void resize(int m) {
        du_t.resize(m); dl_t.resize(m); lam.resize(m);
        chol.resize(static_cast<size_t>(m) * m); rhs.resize(m); lam_ws.resize(m);
        ws.resize(m); side.resize(m);
    }
};

// Solve G_WW lam_ws = -d_W via dense Cholesky on the active block.
int solve_ws(const lmpc_problem* p, Workspace& w, int k) {
    const int m = p->m;
    for (int i = 0; i < k; ++i) {
        const int ci = w.ws[i];
        for (int j = 0; j <= i; ++j)
            w.chol[i * k + j] = p->G[static_cast<size_t>(ci) * m + w.ws[j]];
        w.chol[i * k + i] += p->rho[ci];
        w.rhs[i] = -(w.side[i] ? w.du_t[ci] : w.dl_t[ci]);
    }
    for (int i = 0; i < k; ++i) {
        double s = w.chol[i * k + i];
        for (int t = 0; t < i; ++t) s -= w.chol[i * k + t] * w.chol[i * k + t];
        if (s <= 1e-14) return -1;
        s = std::sqrt(s);
        w.chol[i * k + i] = s;
        for (int j = i + 1; j < k; ++j) {
            double v = w.chol[j * k + i];
            for (int t = 0; t < i; ++t) v -= w.chol[j * k + t] * w.chol[i * k + t];
            w.chol[j * k + i] = v / s;
        }
    }
    for (int i = 0; i < k; ++i) {
        double v = w.rhs[i];
        for (int t = 0; t < i; ++t) v -= w.chol[i * k + t] * w.lam_ws[t];
        w.lam_ws[i] = v / w.chol[i * k + i];
    }
    for (int i = k - 1; i >= 0; --i) {
        double v = w.lam_ws[i];
        for (int t = i + 1; t < k; ++t) v -= w.chol[t * k + i] * w.lam_ws[t];
        w.lam_ws[i] = v / w.chol[i * k + i];
    }
    return 0;
}

int solve_one(const lmpc_problem* p, const double* theta, Workspace& w,
              double* U_out, int* iters_out) {
    const int m = p->m, n = p->n, nth = p->nth;
    for (int i = 0; i < m; ++i) {
        double acc = 0.0;
        const double* row = p->Dth + static_cast<size_t>(i) * nth;
        for (int j = 0; j < nth; ++j) acc += row[j] * theta[j];
        w.du_t[i] = p->du[i] + acc;
        w.dl_t[i] = p->dl[i] + acc;
    }
    std::memset(w.lam.data(), 0, sizeof(double) * m);
    int k = 0;
    for (int i = 0; i < m; ++i)
        if (p->is_eq[i]) { w.ws[k] = i; w.side[k] = 1; ++k; }

    int status = -1;
    int it = 0;
    for (; it < p->iter_limit; ++it) {
        if (k > 0 && solve_ws(p, w, k)) { status = -2; break; }

        // blocking test on removable multipliers
        int kb = -1;
        double alpha = 1.0;
        for (int i = 0; i < k; ++i) {
            const int ci = w.ws[i];
            if (p->is_eq[ci]) continue;
            const double ls = w.lam_ws[i];
            const bool viol = w.side[i] ? (ls < -p->sign_tol) : (ls > p->sign_tol);
            if (viol) {
                const double denom = w.lam[ci] - ls;
                const double a = denom != 0.0 ? w.lam[ci] / denom : 0.0;
                if (kb < 0 || a < alpha) { alpha = a; kb = i; }
            }
        }
        if (kb >= 0) {
            if (alpha < 0.0) alpha = 0.0;
            for (int i = 0; i < k; ++i) {
                const int ci = w.ws[i];
                w.lam[ci] += alpha * (w.lam_ws[i] - w.lam[ci]);
            }
            w.lam[w.ws[kb]] = 0.0;
            for (int i = kb; i < k - 1; ++i) { w.ws[i] = w.ws[i + 1]; w.side[i] = w.side[i + 1]; }
            --k;
            continue;
        }

        std::memset(w.lam.data(), 0, sizeof(double) * m);
        for (int i = 0; i < k; ++i) w.lam[w.ws[i]] = w.lam_ws[i];

        // most violated inactive row
        int jbest = -1, sbest = 1;
        double vbest = p->primal_tol;
        for (int j = 0; j < m; ++j) {
            if (p->is_immutable[j]) continue;
            bool inws = false;
            for (int t = 0; t < k; ++t)
                if (w.ws[t] == j) { inws = true; break; }
            if (inws) continue;
            double c = 0.0;
            const double* row = p->G + static_cast<size_t>(j) * m;
            for (int t = 0; t < k; ++t) c += row[w.ws[t]] * w.lam[w.ws[t]];
            const double vu = -(w.du_t[j] + c);
            const double vl = w.dl_t[j] + c;
            if (vu > vbest) { vbest = vu; jbest = j; sbest = 1; }
            if (vl > vbest) { vbest = vl; jbest = j; sbest = 0; }
        }
        if (jbest < 0) { status = 1; ++it; break; }
        if (k >= m) { status = -3; break; }
        w.ws[k] = jbest; w.side[k] = sbest; ++k;
    }

    for (int i = 0; i < n; ++i) {
        double u = p->u_off[i];
        const double* urow = p->Uth_off + static_cast<size_t>(i) * nth;
        for (int j = 0; j < nth; ++j) u += urow[j] * theta[j];
        const double* hrow = p->HinvET + static_cast<size_t>(i) * m;
        for (int t = 0; t < k; ++t) u -= hrow[w.ws[t]] * w.lam[w.ws[t]];
        U_out[i] = u;
    }
    *iters_out = it;
    return status;
}

}  // namespace

extern "C" {

// Solve B instances; thetas (B, nth) row-major, U_out (B, n), returns 0.
int lmpc_solve_batch(const lmpc_problem* p, const double* thetas, int B,
                     double* U_out, int* iters_out, int* status_out) {
#pragma omp parallel
    {
        Workspace w;
        w.resize(p->m);
#pragma omp for schedule(dynamic, 64)
        for (int b = 0; b < B; ++b) {
            status_out[b] = solve_one(p, thetas + static_cast<size_t>(b) * p->nth,
                                      w, U_out + static_cast<size_t>(b) * p->n,
                                      &iters_out[b]);
        }
    }
    return 0;
}

int lmpc_version(void) { return 1; }

}  // extern "C"
