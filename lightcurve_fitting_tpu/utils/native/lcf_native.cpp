// Native host-side kernels for lightcurve_fitting_tpu.
//
// The accelerator handles all model/likelihood math; these are the host data-path
// hot spots, implemented in C++ and exposed through ctypes (see native.py):
//
//   * lcf_binflux: greedy inverse-variance time binning. The Python reference
//     algorithm (reference lightcurve.py:944-1000) is O(n^2) with per-group
//     array reallocation; for survey-scale light curves (1e5-1e6 rows) this
//     becomes the ingestion bottleneck. Same semantics, single pass over a
//     worklist, no allocation churn.
//
//   * lcf_parse_table: whitespace-separated numeric ASCII parsing
//     (the LC.read hot path for large photometry files).
//
// Build: g++ -O3 -shared -fPIC (see native.py; no external dependencies).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Greedy binning: repeatedly take the first unconsumed point, group every
// unconsumed point within `delta` in time, and emit one bin.
// `bad_err[i]` marks error bars that are zero/999/9999/-1/NaN/masked
// (reference lightcurve.py:972-974). Returns the number of bins.
long lcf_binflux(const double* time, const double* flux, const double* dflux,
                 const uint8_t* bad_err, long n, double delta, int include_zero,
                 double* out_time, double* out_flux, double* out_dflux) {
    uint8_t* used = (uint8_t*)calloc((size_t)n, 1);
    long nbins = 0;
    long start = 0;
    while (true) {
        while (start < n && used[start]) start++;
        if (start >= n) break;
        const double t0 = time[start];

        bool any_bad = false;
        double sum_t = 0.0, sum_f = 0.0;
        double sum_w = 0.0, sum_wf = 0.0;
        long count = 0;
        double sum_t_good = 0.0;
        long count_good = 0;

        for (long i = start; i < n; i++) {
            if (used[i]) continue;
            if (std::fabs(time[i] - t0) <= delta) {
                used[i] = 1;
                sum_t += time[i];
                sum_f += flux[i];
                count++;
                if (bad_err[i]) {
                    any_bad = true;
                } else {
                    const double w = 1.0 / (dflux[i] * dflux[i]);
                    sum_w += w;
                    sum_wf += w * flux[i];
                    sum_t_good += time[i];
                    count_good++;
                }
            }
        }

        if (any_bad && include_zero) {
            out_time[nbins] = sum_t / (double)count;
            out_flux[nbins] = sum_f / (double)count;
            out_dflux[nbins] = 0.0;
        } else {
            out_time[nbins] = sum_t_good / (double)count_good;
            out_flux[nbins] = sum_wf / sum_w;
            out_dflux[nbins] = 1.0 / std::sqrt(sum_w);
        }
        nbins++;
    }
    free(used);
    return nbins;
}

// Parse up to n_rows x n_cols whitespace-separated doubles from `text`.
// Returns the number of complete rows parsed; unparsable fields become NaN
// and set the corresponding mask byte.
long lcf_parse_table(const char* text, long text_len, long n_cols, long max_rows,
                     double* out, uint8_t* mask) {
    const char* p = text;
    const char* end = text + text_len;
    long row = 0;
    while (p < end && row < max_rows) {
        // skip to the next non-empty, non-comment line start
        while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t')) p++;
        if (p >= end) break;
        if (*p == '#') {
            while (p < end && *p != '\n') p++;
            continue;
        }
        long col = 0;
        while (col < n_cols && p < end && *p != '\n') {
            while (p < end && (*p == ' ' || *p == '\t')) p++;
            if (p >= end || *p == '\n') break;
            char* next = nullptr;
            double v = strtod(p, &next);
            if (next == p) {  // not a number: consume the token, mask it
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n') p++;
                out[row * n_cols + col] = NAN;
                mask[row * n_cols + col] = 1;
            } else {
                p = next;
                out[row * n_cols + col] = v;
                mask[row * n_cols + col] = 0;
            }
            col++;
        }
        if (col == n_cols) row++;
        while (p < end && *p != '\n') p++;  // skip trailing fields
    }
    return row;
}

}  // extern "C"
