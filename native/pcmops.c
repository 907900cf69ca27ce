/* pcmops — native host-side PCM primitives.
 *
 * The reference delegated all hot host PCM arithmetic to CPython's C
 * audioop module (SURVEY.md §3.3), which is deprecated and removed in
 * Python 3.13.  This library is the rebuild's own native equivalent for
 * the *host* paths where device dispatch latency dominates: realtime
 * mixer chunk addition (~1470 frames every 33 ms) and level metering.
 * Bulk offline DSP stays on the device.
 *
 * Semantics match goldref.pcm exactly: saturating adds; float32-spec
 * scaling (f32 product, floor, clamp); peak/mean-square metering.
 * Built with `make -C native` (or on demand by utils/native.py) into
 * libpcmops.so and bound via ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <math.h>

#define API __attribute__((visibility("default")))

static inline int16_t clamp16(int32_t v) {
    if (v > 32767) return 32767;
    if (v < -32768) return -32768;
    return (int16_t)v;
}

static inline int32_t clamp32(int64_t v) {
    if (v > 2147483647LL) return 2147483647;
    if (v < -2147483648LL) return (int32_t)-2147483648LL;
    return (int32_t)v;
}

/* Element-wise saturating add (audioop.add, width 2). */
API void sat_add_i16(const int16_t *a, const int16_t *b, int16_t *out,
                     size_t n) {
    for (size_t i = 0; i < n; i++)
        out[i] = clamp16((int32_t)a[i] + (int32_t)b[i]);
}

/* Element-wise saturating add (audioop.add, width 4). */
API void sat_add_i32(const int32_t *a, const int32_t *b, int32_t *out,
                     size_t n) {
    for (size_t i = 0; i < n; i++)
        out[i] = clamp32((int64_t)a[i] + (int64_t)b[i]);
}

/* K-way chunk mix: sum K int16 streams in int32, saturate once at the end
 * (the RealTimeMixer hot loop; same result as the device _mix_chunks). */
API void mix_k_i16(const int16_t **bufs, int k, int16_t *out, size_t n) {
    for (size_t i = 0; i < n; i++) {
        int32_t acc = 0;
        for (int j = 0; j < k; j++)
            acc += bufs[j][i];
        out[i] = clamp16(acc);
    }
}

/* Scale by f32 factor: f32 product, floorf, clamp (the f32 spec of
 * goldref.pcm.mul_f32 / device mul_floor). */
API void mul_floor_i16(const int16_t *a, float factor, int16_t *out,
                       size_t n) {
    for (size_t i = 0; i < n; i++) {
        float p = (float)a[i] * factor;
        float f = floorf(p);
        if (f > 32767.0f) f = 32767.0f;
        if (f < -32768.0f) f = -32768.0f;
        out[i] = (int16_t)f;
    }
}

/* Peak |x| (audioop.max). */
API int32_t peak_i16(const int16_t *a, size_t n) {
    int32_t m = 0;
    for (size_t i = 0; i < n; i++) {
        int32_t v = a[i] < 0 ? -(int32_t)a[i] : a[i];
        if (v > m) m = v;
    }
    return m;
}

/* Mean of squares (for RMS metering; caller takes sqrt). */
API double mean_square_i16(const int16_t *a, size_t n) {
    if (n == 0) return 0.0;
    double acc = 0.0;
    for (size_t i = 0; i < n; i++)
        acc += (double)a[i] * (double)a[i];
    return acc / (double)n;
}

/* Interleaved stereo peak per channel. */
API void vu_i16(const int16_t *a, size_t nframes, int32_t *peaks,
                double *mean_squares) {
    int32_t pl = 0, pr = 0;
    double ml = 0.0, mr = 0.0;
    for (size_t i = 0; i < nframes; i++) {
        int32_t l = a[2 * i], r = a[2 * i + 1];
        int32_t al = l < 0 ? -l : l, ar = r < 0 ? -r : r;
        if (al > pl) pl = al;
        if (ar > pr) pr = ar;
        ml += (double)l * (double)l;
        mr += (double)r * (double)r;
    }
    peaks[0] = pl;
    peaks[1] = pr;
    mean_squares[0] = nframes ? ml / (double)nframes : 0.0;
    mean_squares[1] = nframes ? mr / (double)nframes : 0.0;
}
