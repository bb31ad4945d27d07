// H12 stream_copy: out = in over n floats, the byte floor of a pass that
// reads P once and writes it once.
//
// Replaces the TPU kernel benchmarks/probe_rankpass.py:144 copy_step (its
// copy_kernel, a pure (256, D) row-panel stream of P).
//
// What bounds it on the card: bytes alone, 2 n x 4 B (at D = 2304, 42.5 MB:
// 12.7 us at the spec sheet's 3.35 TB/s).  So it does nothing but move
// them: 16-byte loads and stores (ld.global.cs / st.global.cs: the data is
// used once, so it is marked evict-first in the caches), a
// grid-stride loop over enough blocks to fill every SM, four 16-byte loads
// in flight a thread before its first store.  A tail that is not a whole
// 16 bytes (n % 4, or a misaligned pointer) goes 4 bytes at a time.
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
stream_copy_kernel(const float4* __restrict__ in, float4* __restrict__ out, long long n4) {
    const long long stride = (long long)gridDim.x * THREADS;
    long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(in + i + u * stride);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) __stcs(out + i + u * stride, v[u]);
    }
    for (; i < n4; i += stride) __stcs(out + i, __ldcs(in + i));
}

__global__ void stream_copy_tail(const float* __restrict__ in, float* __restrict__ out,
                                 long long n) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x)
        out[i] = in[i];
}

constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES] = {};

}  // namespace

extern "C" int csl_stream_copy(const float* in, float* out, long long n, void* stream) {
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (g_sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const bool aligned = ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) & 15) == 0;
    const long long n4 = aligned ? n / 4 : 0;
    if (n4 > 0) {
        // Four blocks of 512 threads an SM (2,048 threads, the SM's most),
        // fewer when there are fewer 16-byte words than threads.
        const long long want = (n4 + THREADS - 1) / THREADS;
        const int blocks = (int)(want < 4LL * g_sms[dev] ? want : 4LL * g_sms[dev]);
        stream_copy_kernel<<<blocks, THREADS, 0, st>>>(reinterpret_cast<const float4*>(in),
                                                       reinterpret_cast<float4*>(out), n4);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const long long rest = n - 4 * n4;
    if (rest > 0) {
        const int blocks = (int)((rest + 255) / 256 < 4LL * g_sms[dev] ? (rest + 255) / 256
                                                                        : 4LL * g_sms[dev]);
        stream_copy_tail<<<blocks, 256, 0, st>>>(in + 4 * n4, out + 4 * n4, rest);
        err = cudaGetLastError();
    }
    return (int)err;
}
