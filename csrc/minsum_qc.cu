// Fixed-point min-sum family decoder for QC-LDPC codes on NVIDIA Hopper,
// called from JAX through the XLA FFI (ldpc_tpu/kernels/minsum_cuda.py).
//
// One thread block decodes a tile of T codewords for every iteration with
// the whole decoder state in shared memory:
//   * int16 posteriors, laid out post[v * T + b] (v = variable node,
//     b = codeword lane), two copies for the flooding schedule;
//   * int8 check-to-variable messages, c2v[(e * Z + z) * T + b] for base
//     entry e and circulant row z.
// Only the int8 channel LLRs come in and the hard bits, iteration counts and
// convergence flags go out, so device memory sees n bytes in and n + 5 bytes
// out per codeword.
//
// Thread (zs, b) = (threadIdx.x / T, threadIdx.x % T) owns check rows
// z = zs, zs + zslots, ... of every layer for codeword lane b. A circulant
// shift is index arithmetic: entry (col, s) of check row z reads variable
// col * Z + (z + s) mod Z. Within one layer every base column appears at
// most once (codes/layout.py asserts it), so no two threads of a layer touch
// the same variable and a layer needs no atomics; layers are separated by
// __syncthreads().
//
// Bit-exactness contract (golden/decoder.py): v2c = clip(post - c2v_old,
// +-qmax); c2v = sign product * transformed excluded minimum, with ties
// resolved by value (|v| == min1 takes min2, so tied entries all get min1);
// sign(0) = +1 (bit 31 of the XOR accumulator); NMS scaling and the offset
// are applied to min1/min2 once per check, which equals the golden per-edge
// transform because both are monotonic. Posteriors stay within
// qmax * (dv + 2), which the Python wrapper checks fits int16.
//
// Early termination freezes a lane at its first syndrome success (the lane
// stops updating; its iteration count stops), and the block leaves the
// iteration loop when every lane of its tile has converged.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct Params {
  int Z, n, mb, n_entries, T, zslots, max_iter;
  int qmax, beta, alpha_num, alpha_shift;  // alpha_shift < 0: no scaling
  int flooding, early_term;
  // byte offsets of the shared-memory regions
  int off_bad, off_post, off_post2, off_c2v;
};

constexpr int kBig = 1 << 14;

__device__ __forceinline__ int wrap(int z, int Z) { return z >= Z ? z - Z : z; }

// True when any check row owned by this thread is unsatisfied.
__device__ bool rows_unsat(const int16_t* post, const int* off,
                           const int* colZ, const int* shift, const Params& p,
                           int zs, int b) {
  for (int z = zs; z < p.Z; z += p.zslots) {
    for (int L = 0; L < p.mb; ++L) {
      int par = 0;
      for (int e = off[L]; e < off[L + 1]; ++e) {
        const int v = colZ[e] + wrap(z + shift[e], p.Z);
        par ^= post[v * p.T + b] < 0;
      }
      if (par) return true;
    }
  }
  return false;
}

// One layer's check-node update for check row z of lane b. Layered: src ==
// dst (running posterior). Flooding: src holds the previous iteration's
// totals and dst accumulates the new ones as src + sum(new - old).
__device__ __forceinline__ void check_update(const int16_t* src,
                                             int16_t* dst, int8_t* c2v,
                                             int e0, int e1, const int* colZ,
                                             const int* shift, const Params& p,
                                             int z, int b) {
  int min1 = kBig, min2 = kBig, sgn = 0;
  for (int e = e0; e < e1; ++e) {
    const int v = colZ[e] + wrap(z + shift[e], p.Z);
    const int old = c2v[(e * p.Z + z) * p.T + b];
    const int x = max(-p.qmax, min(p.qmax, int(src[v * p.T + b]) - old));
    const int m = abs(x);
    min2 = min(min2, max(min1, m));
    min1 = min(min1, m);
    sgn ^= x;
  }
  int o1 = min1, o2 = min2;
  if (p.alpha_shift >= 0) {
    o1 = (o1 * p.alpha_num) >> p.alpha_shift;
    o2 = (o2 * p.alpha_num) >> p.alpha_shift;
  }
  if (p.beta) {
    o1 = max(o1 - p.beta, 0);
    o2 = max(o2 - p.beta, 0);
  }
  for (int e = e0; e < e1; ++e) {
    const int v = colZ[e] + wrap(z + shift[e], p.Z);
    const int ci = (e * p.Z + z) * p.T + b;
    const int old = c2v[ci];
    const int raw = int(src[v * p.T + b]) - old;
    const int x = max(-p.qmax, min(p.qmax, raw));
    const int mag = abs(x) == min1 ? o2 : o1;
    const int nw = (sgn ^ x) < 0 ? -mag : mag;
    c2v[ci] = static_cast<int8_t>(nw);
    if (p.flooding) {
      dst[v * p.T + b] = static_cast<int16_t>(dst[v * p.T + b] + nw - old);
    } else {
      dst[v * p.T + b] = static_cast<int16_t>(raw + nw);
    }
  }
}

__global__ void __launch_bounds__(1024)
    minsum_qc_kernel(const int8_t* __restrict__ chan,
                     const int32_t* __restrict__ table,
                     uint8_t* __restrict__ hard, int32_t* __restrict__ iters,
                     uint8_t* __restrict__ conv, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* off = reinterpret_cast<int*>(smem);  // mb + 1 layer offsets
  int* colZ = off + p.mb + 1;               // n_entries
  int* shift = colZ + p.n_entries;          // n_entries
  int* bad = reinterpret_cast<int*>(smem + p.off_bad);  // 2 x T
  int16_t* tot = reinterpret_cast<int16_t*>(smem + p.off_post);
  int16_t* nxt = reinterpret_cast<int16_t*>(smem + p.off_post2);
  int8_t* c2v = reinterpret_cast<int8_t*>(smem + p.off_c2v);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int T = p.T, n = p.n;
  const int b = tid % T, zs = tid / T;
  const long long first = static_cast<long long>(blockIdx.x) * T;

  const int tab_len = p.mb + 1 + 2 * p.n_entries;
  for (int i = tid; i < tab_len; i += nthr) off[i] = table[i];
  for (int i = tid; i < 2 * T; i += nthr) bad[i] = 0;
  const int8_t* cin = chan + first * n;
  for (int i = tid; i < T * n; i += nthr) {
    const int bb = i / n, v = i - bb * n;
    tot[v * T + bb] = cin[i];
  }
  int* c2v_words = reinterpret_cast<int*>(c2v);
  const int n_words = p.n_entries * p.Z * T / 4;  // T % 8 == 0
  for (int i = tid; i < n_words; i += nthr) c2v_words[i] = 0;
  __syncthreads();

  bool done = false;
  int cur = 0, it_count = 0;
  if (p.early_term) {
    if (rows_unsat(tot, off, colZ, shift, p, zs, b)) bad[b] = 1;
    __syncthreads();
    done = !bad[b];
    cur = 1;
  }

  for (int it = 0; it < p.max_iter; ++it) {
    if (p.early_term) {
      if (!__syncthreads_or(!done)) break;
    } else {
      __syncthreads();
    }
    if (p.flooding) {
      // frozen lanes keep their totals: start the new totals as a copy
      const int4* s4 = reinterpret_cast<const int4*>(tot);
      int4* d4 = reinterpret_cast<int4*>(nxt);
      for (int i = tid; i < n * T / 8; i += nthr) d4[i] = s4[i];
    }
    for (int L = 0; L < p.mb; ++L) {
      __syncthreads();
      if (done) continue;
      for (int z = zs; z < p.Z; z += p.zslots) {
        check_update(tot, p.flooding ? nxt : tot, c2v, off[L], off[L + 1],
                     colZ, shift, p, z, b);
      }
    }
    it_count += !done;
    if (p.flooding) {
      int16_t* t = tot;
      tot = nxt;
      nxt = t;
    }
    if (p.early_term) {
      __syncthreads();
      if (!done && rows_unsat(tot, off, colZ, shift, p, zs, b))
        bad[cur * T + b] = 1;
      if (zs == 0) bad[(cur ^ 1) * T + b] = 0;
      __syncthreads();
      done = done || !bad[cur * T + b];
      cur ^= 1;
    }
  }

  __syncthreads();
  if (!p.early_term) {
    // fixed iterations: convergence is the final syndrome (bad[] is all
    // zero here, it is only written on the early-termination path)
    if (rows_unsat(tot, off, colZ, shift, p, zs, b)) bad[b] = 1;
    __syncthreads();
    done = !bad[b];
  }
  uint8_t* hout = hard + first * n;
  for (int i = tid; i < T * n; i += nthr) {
    const int bb = i / n, v = i - bb * n;
    hout[i] = tot[v * T + bb] < 0;
  }
  if (zs == 0) {
    iters[first + b] = it_count;
    conv[first + b] = done;
  }
}

int align16(int x) { return (x + 15) & ~15; }

ffi::Error MinsumQcImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> chan,
                        ffi::Buffer<ffi::S32> table,
                        ffi::ResultBuffer<ffi::U8> hard,
                        ffi::ResultBuffer<ffi::S32> iters,
                        ffi::ResultBuffer<ffi::U8> conv, int64_t Z,
                        int64_t mb, int64_t n_entries, int64_t tile,
                        int64_t zslots, int64_t max_iter, int64_t qmax,
                        int64_t beta, int64_t alpha_num, int64_t alpha_shift,
                        int64_t flooding, int64_t early_term) {
  auto dims = chan.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("chan must be 2-D");
  const int64_t B = dims[0], n = dims[1];
  if (B % tile || tile % 8 || n % Z)
    return ffi::Error::InvalidArgument("batch, tile or length mismatch");
  if (table.element_count() != static_cast<size_t>(mb + 1 + 2 * n_entries))
    return ffi::Error::InvalidArgument("table length mismatch");

  Params p;
  p.Z = Z; p.n = n; p.mb = mb; p.n_entries = n_entries; p.T = tile;
  p.zslots = zslots; p.max_iter = max_iter; p.qmax = qmax; p.beta = beta;
  p.alpha_num = alpha_num; p.alpha_shift = alpha_shift;
  p.flooding = flooding; p.early_term = early_term;
  const int post_bytes = align16(static_cast<int>(n * tile * 2));
  p.off_bad = align16(static_cast<int>((mb + 1 + 2 * n_entries) * 4));
  p.off_post = p.off_bad + align16(static_cast<int>(2 * tile * 4));
  p.off_post2 = p.off_post + post_bytes;
  p.off_c2v = p.off_post2 + (flooding ? post_bytes : 0);
  const int smem = p.off_c2v + static_cast<int>(n_entries * Z * tile);

  cudaError_t err = cudaFuncSetAttribute(
      minsum_qc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  if (B > 0) {
    minsum_qc_kernel<<<B / tile, tile * zslots, smem, stream>>>(
        chan.typed_data(), table.typed_data(), hard->typed_data(),
        iters->typed_data(), conv->typed_data(), p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LdpcMinsumQc, MinsumQcImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int64_t>("Z")
                                  .Attr<int64_t>("mb")
                                  .Attr<int64_t>("n_entries")
                                  .Attr<int64_t>("tile")
                                  .Attr<int64_t>("zslots")
                                  .Attr<int64_t>("max_iter")
                                  .Attr<int64_t>("qmax")
                                  .Attr<int64_t>("beta")
                                  .Attr<int64_t>("alpha_num")
                                  .Attr<int64_t>("alpha_shift")
                                  .Attr<int64_t>("flooding")
                                  .Attr<int64_t>("early_term"));
