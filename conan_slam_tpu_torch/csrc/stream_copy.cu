// H12 stream_copy: out = in over n floats, the byte floor of a pass that
// reads P once and writes it once.
//
// Replaces the TPU kernel benchmarks/probe_rankpass.py:144 copy_step (its
// copy_kernel, a pure (256, D) row-panel stream of P).
//
// What bounds it on the card: bytes alone, 2 n x 4 B (at D = 2304, 42.5 MB:
// 12.7 us at the spec sheet's 3.35 TB/s).  So it does nothing but move
// them, by the tensor memory accelerator (TMA), Hopper's own way to stream
// bytes: one persistent block of one warp an SM, block b taking the chunks
// b, b + grid, ... of CHUNK bytes in that order (so the SMs stream
// neighbouring chunks at a time; an equal contiguous range a block was
// slower), through a ring of STAGES chunks in shared memory.  One thread a
// block issues everything: a bulk copy global -> shared into a stage
// (cp.async.bulk ... mbarrier::complete_tx::bytes, completing on that
// stage's mbarrier), then, once it has landed, a bulk copy shared ->
// global out of it (cp.async.bulk ... bulk_group), and it refills a stage
// with the chunk STAGES further on once the store out of it has read it
// (cp.async.bulk.wait_group.read), one store behind, so STAGES - 1 loads
// stay in flight beside the stores.  The copies carry no L2 policy:
// evict-first on either side moved nothing past the L2.  CHUNK and STAGES
// are the measured best of 4 to 64 KB and 3 to 32 stages (PERF.md).  A
// tail that is not a whole 16 bytes goes 4 bytes at a time, and so does
// the whole copy when in or out is not 16-byte aligned.  The launch
// allocates nothing and is capturable.
#include "common.cuh"

namespace {

constexpr int CHUNK = 16384;    // bytes a bulk copy
constexpr int STAGES = 8;       // chunks in a block's ring
constexpr size_t SMEM = (size_t)STAGES * CHUNK + STAGES * sizeof(unsigned long long);
static_assert(SMEM <= CSL_MAX_SMEM, "the ring fits one block's shared memory");

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(csl_smem_addr(bar)), "r"(parity)
            : "memory");
}

// n bytes global -> shared into dst, completing on bar (armed here).
__device__ __forceinline__ void bulk_load(unsigned char* dst, const char* src, unsigned n,
                                          unsigned long long* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(csl_smem_addr(bar)),
                 "r"(n)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            csl_smem_addr(dst)),
        "l"(src), "r"(n), "r"(csl_smem_addr(bar))
        : "memory");
}

// n bytes shared -> global from src, in one bulk group.
__device__ __forceinline__ void bulk_store(char* dst, const unsigned char* src, unsigned n) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(csl_smem_addr(src)), "r"(n)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
stream_copy_kernel(const char* __restrict__ in, char* __restrict__ out, long long bytes) {
    extern __shared__ __align__(128) unsigned char ring[];
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(ring + (size_t)STAGES * CHUNK);
    if (threadIdx.x != 0) return;
    // This block's chunks c = 0, 1, ...: chunk blockIdx.x + c gridDim.x of the whole.
    const long long all = (bytes + CHUNK - 1) / CHUNK;
    const long long chunks = blockIdx.x < all ? (all - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    auto start = [&](long long c) { return (blockIdx.x + c * gridDim.x) * CHUNK; };
    auto size = [&](long long c) {
        return (unsigned)(bytes - start(c) < CHUNK ? bytes - start(c) : CHUNK);
    };
    for (int s = 0; s < STAGES; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(csl_smem_addr(bar + s))
                     : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

    for (long long c = 0; c < chunks && c < STAGES; ++c)
        bulk_load(ring + (size_t)c * CHUNK, in + start(c), size(c), bar + c);
    for (long long c = 0; c < chunks; ++c) {
        const int s = (int)(c % STAGES);
        bar_wait(bar + s, (unsigned)((c / STAGES) & 1));
        bulk_store(out + start(c), ring + (size_t)s * CHUNK, size(c));
        // Refill the stage stored one step ago, once that store has read it.
        const long long r = c - 1 + STAGES;
        if (c >= 1 && r < chunks) {
            asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
            const int sr = (int)(r % STAGES);
            bulk_load(ring + (size_t)sr * CHUNK, in + start(r), size(r), bar + sr);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
        err = csl_allow_smem(stream_copy_kernel, SMEM);
        if (err != cudaSuccess) return (int)err;
        const long long want = (16 * n4 + CHUNK - 1) / CHUNK;
        const int blocks = (int)(want < g_sms[dev] ? want : g_sms[dev]);
        stream_copy_kernel<<<blocks, 32, SMEM, st>>>(reinterpret_cast<const char*>(in),
                                                     reinterpret_cast<char*>(out), 16 * n4);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const long long rest = n - 4 * n4;
    if (rest > 0) {
        const long long want = (rest + 255) / 256, most = 4LL * g_sms[dev];
        stream_copy_tail<<<(int)(want < most ? want : most), 256, 0, st>>>(in + 4 * n4,
                                                                            out + 4 * n4, rest);
        err = cudaGetLastError();
    }
    return (int)err;
}
