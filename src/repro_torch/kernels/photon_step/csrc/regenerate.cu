// Regeneration kernel for NVIDIA Hopper (sm_90a): relaunch the dead
// photon lanes of S scenarios, one C call a round, with the bits that
// repro_torch/core/simulator.py _regenerate gives through PyTorch's
// elementwise operators.
//
// Replaces: no TPU kernel.  The reference regenerates inside its jitted
//   round (repro/core/simulator.py _regenerate, a masked prefix sum and
//   the source's sample that XLA fuses).  The port's round loop issued
//   the same work as ~160 (pencil) to ~310 (disk) separate PyTorch
//   operations a round from Python: the prefix sums, the 64-bit ids, the
//   int64 RNG-word arithmetic of rng.seed_state (splitmix32 through
//   16-bit halves), the source's formulas and photon.launch, each over
//   every lane.  Their host issue set the pace of a round.
//
// What bounds it.  Bytes: every lane's alive flag (and, in static mode,
//   its launched count and quota) is read, and each relaunched lane's
//   state written, ~90 B with its launched count, more with ppath and
//   lane_ids.  Mid-run about one lane in twelve relaunches, so a round
//   of 262144 lanes moves ~2.3 MB: under a microsecond at 3.35 TB/s.
//   The three launches' fixed costs, a few microseconds each, are what
//   a call takes.
//
// What the design does about it:
//   - One C call, three launches, no host read between them: a count of
//     the candidate lanes in each tile of kThreads lanes (count_kernel),
//     a scan of each scenario's tile counts into exclusive prefixes,
//     which also sets the scenario's counters (scan_kernel, one block a
//     scenario), and the relaunch (relaunch_kernel), where a lane's
//     0-based rank among its scenario's candidates is its tile's prefix
//     plus the candidates before it in the tile (ballots).
//   - Only relaunched lanes are written, in place; every other lane is
//     read once for its flag and left alone.
//   - The scenario's counters are read by the scan, which saves the old
//     photon budget in scratch before it writes the new one, so the
//     relaunch never reads a counter that this call rewrites.  The
//     advanced 64-bit id goes to a buffer of its own (next_out), as the
//     round loop keeps the old low word for its counters.
//   - The launched weight is int64 fixed point (rint of w0 * 2^24 a
//     lane), summed in the block and added with one integer atomic a
//     block, so the order of the adds changes nothing.
//
// Parity.  The RNG words are native uint32_t: splitmix32 seeding of the
//   in-flight stream (seed, id) and the launch stream (seed ^ salt, id),
//   the high id word folded in with kHiMult and the low one with
//   kIdMult, an all-zero state replaced by 0xDEADBEEF in every word, as
//   repro_torch/core/rng.py does in int64.  Each float follows
//   repro_torch/sources/base.py and types.py operation by operation:
//   built with --fmad=false and without fast math, sqrtf, logf, cosf,
//   sinf and IEEE division give what PyTorch's CUDA operators give;
//   torch.clamp and torch.minimum keep a NaN, as clamp_nan and min_nan
//   do here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// One lane a thread, kThreads lanes a tile (a block of count_kernel and
// relaunch_kernel); one block of kScanThreads a scenario for the scan.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kParams = 5;

// repro_torch/core/rng.py and sources/base.py
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr uint32_t kHiMult = 0x85EBCA77u;
constexpr uint32_t kIdMult = 0x9E3779B1u;
constexpr uint32_t kZeroFix = 0xDEADBEEFu;
constexpr uint32_t kLaunchSalt = 0xA511CE50u;
constexpr float kU24 = 5.9604644775390625e-08f;       // 2^-24
constexpr float kTwoPi = 6.28318548202514648f;        // float32(2 pi)
constexpr int kTotalShift = 24;                       // spec.TOTAL_SHIFT
constexpr float kTotalScale = 16777216.0f;            // 2^kTotalShift
constexpr float kNormMin = 1e-12f;

// Source types (kernels/photon_step/regenerate.py SOURCES).
constexpr int kPencil = 0, kIsotropic = 1, kCone = 2, kGaussian = 3,
              kDisk = 4, kPlanar = 5, kLine = 6;

typedef unsigned long long u64;

struct Args {
  float* pos;               // (S * n, 3) lane state, in place
  float* dir;               // (S * n, 3)
  int32_t* ivox;            // (S * n, 3)
  float* w;                 // (S * n)
  float* s_left;            // (S * n)
  float* t;                 // (S * n)
  int64_t* rng;             // (S * n, 4) words in [0, 2^32)
  uint8_t* alive;           // (S * n)
  int64_t* remaining;       // (S) photon budget, in place
  int64_t* launched;        // (S * n) launches a lane, in place
  const int64_t* quota;     // (S * n) static mode's launches a lane
  const int64_t* next_lo;   // (S) next photon id, low word
  const int64_t* next_hi;   // (S) next photon id, high word
  const int64_t* seeds;     // (S) seed words
  u64* launched_w;          // (S) launched weight, 2^-24 units, added into
  int64_t* next_out;        // (2, S) the advanced ids: lo row, hi row
  long long* scratch;       // (S + S * tiles): old budgets, tile counts
  float* ppath;             // (S * n, n_media) or null
  int64_t* lane_ids;        // (S * n, 2) or null
  const float* prm[kParams];  // staged (S, ...) source parameters
  int n, scenarios, tiles, dynamic, kind, optional, n_media, rows, cols;
  int nx, ny, nz;
};

struct Rng {
  uint32_t x, y, z, w;
  __device__ __forceinline__ float uniform() {
    uint32_t t = x ^ (x << 11);
    t = t ^ (t >> 8);
    const uint32_t nw = (w ^ (w >> 19)) ^ t;
    x = y;
    y = z;
    z = w;
    w = nw;
    return ((float)(nw >> 8) + 0.5f) * kU24;
  }
};

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  uint32_t z = x + kGolden;
  z = (z ^ (z >> 16)) * kMix1;
  z = (z ^ (z >> 13)) * kMix2;
  return z ^ (z >> 16);
}

// rng.seed_state(seed, (lo, hi))
__device__ __forceinline__ Rng seed_state(uint32_t seed, uint32_t lo,
                                          uint32_t hi) {
  const uint32_t hmix = hi * kHiMult;
  uint32_t x = seed ^ (lo * kIdMult);
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x = splitmix32(x + (uint32_t)k * kGolden + hmix);
    v[k] = x;
  }
  if ((v[0] | v[1] | v[2] | v[3]) == 0u) v[0] = v[1] = v[2] = v[3] = kZeroFix;
  Rng r;
  r.x = v[0];
  r.y = v[1];
  r.z = v[2];
  r.w = v[3];
  return r;
}

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.minimum(a, b)
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// sources/base.py isotropic_direction
__device__ __forceinline__ void isotropic_direction(float u_cos, float u_phi,
                                                    float* d) {
  const float cost = 2.0f * u_cos - 1.0f;
  const float sint = sqrtf(clamp_nan(1.0f - cost * cost, 0.0f));
  const float phi = kTwoPi * u_phi;
  d[0] = sint * cosf(phi);
  d[1] = sint * sinf(phi);
  d[2] = cost;
}

// sources/base.py radial_offset, on a position already holding pos
__device__ __forceinline__ void radial_offset(float* p, float r, float u_phi,
                                              const float* e1,
                                              const float* e2) {
  const float phi = kTwoPi * u_phi;
  const float a = r * cosf(phi);
  const float b = r * sinf(phi);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = (p[k] + a * e1[k]) + b * e2[k];
}

// sources/base.py direction_from_axis
__device__ __forceinline__ void direction_from_axis(float cost, float phi,
                                                    const float* axis,
                                                    const float* e1,
                                                    const float* e2,
                                                    float* d) {
  cost = clamp_nan(cost, -1.0f, 1.0f);
  const float sint = sqrtf(clamp_nan(1.0f - cost * cost, 0.0f));
  const float a = sint * cosf(phi);
  const float b = sint * sinf(phi);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = (a * e1[k] + b * e2[k]) + cost * axis[k];
  const float norm = sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]);
  const float den = clamp_nan(norm, kNormMin);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = d[k] / den;
}

__device__ __forceinline__ void load3(const float* p, int sc, float* v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = p[3 * sc + k];
}

__device__ __forceinline__ bool candidate(const Args& A, long long lane) {
  if (A.alive[lane]) return false;
  return A.dynamic || A.launched[lane] < A.quota[lane];
}

// The source's launch state of photon (lo, hi) of scenario sc
// (sources/types.py sample_staged); returns w0.
__device__ __forceinline__ float sample(const Args& A, int sc, uint32_t lo,
                                        uint32_t hi, float* p, float* d,
                                        Rng* flight) {
  const uint32_t seed = (uint32_t)A.seeds[sc];
  const int kind = A.kind;
  float u[3] = {0.f, 0.f, 0.f};
  if (kind != kPencil) {  // two launch uniforms, three for a line
    Rng ls = seed_state(seed ^ kLaunchSalt, lo, hi);
    u[0] = ls.uniform();
    u[1] = ls.uniform();
    if (kind == kLine) u[2] = ls.uniform();
  }
  float w0 = 1.0f;
  switch (kind) {
    case kPencil:
      load3(A.prm[0], sc, p);
      load3(A.prm[1], sc, d);
      break;
    case kIsotropic:
      load3(A.prm[0], sc, p);
      isotropic_direction(u[0], u[1], d);
      break;
    case kCone: {
      float axis[3], e1[3], e2[3];
      load3(A.prm[0], sc, p);
      load3(A.prm[1], sc, axis);
      load3(A.prm[2], sc, e1);
      load3(A.prm[3], sc, e2);
      const float cost = 1.0f - u[0] * A.prm[4][sc];
      direction_from_axis(cost, kTwoPi * u[1], axis, e1, e2, d);
      break;
    }
    case kGaussian:
    case kDisk: {
      float e1[3], e2[3];
      load3(A.prm[0], sc, p);
      load3(A.prm[1], sc, d);
      load3(A.prm[2], sc, e1);
      load3(A.prm[3], sc, e2);
      const float r = kind == kGaussian
                          ? A.prm[4][sc] * sqrtf(-logf(u[0]) * 0.5f)
                          : A.prm[4][sc] * sqrtf(u[0]);
      radial_offset(p, r, u[1], e1, e2);
      break;
    }
    case kPlanar: {
      float v1[3], v2[3];
      load3(A.prm[0], sc, p);
      load3(A.prm[1], sc, v1);
      load3(A.prm[2], sc, v2);
      load3(A.prm[3], sc, d);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = (p[k] + u[0] * v1[k]) + u[1] * v2[k];
      if (A.optional) {  // the pattern's weights, cell (ia, ib)
        const int rows = A.rows, cols = A.cols;
        int ia = (int)(u[0] * (float)rows);
        int ib = (int)(u[1] * (float)cols);
        ia = ia < 0 ? 0 : (ia > rows - 1 ? rows - 1 : ia);
        ib = ib < 0 ? 0 : (ib > cols - 1 ? cols - 1 : ib);
        w0 = A.prm[4][(long long)sc * rows * cols + ia * cols + ib];
      }
      break;
    }
    default: {  // kLine: a slit along its dir, else isotropic
      float end[3];
      load3(A.prm[0], sc, p);
      load3(A.prm[1], sc, end);
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = p[k] + u[0] * (end[k] - p[k]);
      if (A.optional)
        load3(A.prm[2], sc, d);
      else
        isotropic_direction(u[1], u[2], d);
      break;
    }
  }
  *flight = seed_state(seed, lo, hi);
  return w0;
}

// Relaunch one lane as photon (base id + rank) of its scenario
// (photon.launch); returns its launched weight in 2^-24 units.
__device__ __forceinline__ long long relaunch_lane(const Args& A, int sc,
                                                   long long lane,
                                                   long long rank) {
  const uint32_t base_lo = (uint32_t)A.next_lo[sc];
  const uint32_t lo = base_lo + (uint32_t)rank;
  const uint32_t hi = (uint32_t)A.next_hi[sc] + (lo < base_lo ? 1u : 0u);
  float p[3], d[3];
  Rng r;
  const float w0 = sample(A, sc, lo, hi, p, d, &r);
  const int bound[3] = {A.nx, A.ny, A.nz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = min_nan(clamp_nan(p[k], 0.0f), (float)bound[k]);
    int iv = (int)floorf(v);
    iv = iv < 0 ? 0 : iv;
    iv = iv < bound[k] - 1 ? iv : bound[k] - 1;
    A.pos[3 * lane + k] = v;
    A.dir[3 * lane + k] = d[k];
    A.ivox[3 * lane + k] = iv;
  }
  A.w[lane] = w0;
  A.s_left[lane] = 0.0f;
  A.t[lane] = 0.0f;
  A.rng[4 * lane + 0] = (int64_t)r.x;
  A.rng[4 * lane + 1] = (int64_t)r.y;
  A.rng[4 * lane + 2] = (int64_t)r.z;
  A.rng[4 * lane + 3] = (int64_t)r.w;
  A.alive[lane] = 1;
  A.launched[lane] += 1;
  if (A.ppath != nullptr)
    for (int m = 0; m < A.n_media; ++m) A.ppath[lane * A.n_media + m] = 0.0f;
  if (A.lane_ids != nullptr) {
    A.lane_ids[2 * lane + 0] = (int64_t)lo;
    A.lane_ids[2 * lane + 1] = (int64_t)hi;
  }
  return (long long)rintf(w0 * kTotalScale);
}

// --- COUNT: candidate lanes a tile ---
__global__ void __launch_bounds__(kThreads)
    count_kernel(const __grid_constant__ Args A) {
  const int sc = blockIdx.y;
  const int local = blockIdx.x * kThreads + threadIdx.x;
  const bool c = local < A.n && candidate(A, (long long)sc * A.n + local);
  const int count = __syncthreads_count(c);
  if (threadIdx.x == 0)
    A.scratch[A.scenarios + (long long)sc * A.tiles + blockIdx.x] = count;
}

// --- SCAN: a scenario's tile counts into exclusive prefixes; its
// budget, next id and relaunch count ---
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const __grid_constant__ Args A) {
  __shared__ long long s_warp[kScanThreads / 32];
  __shared__ long long s_carry;
  const int sc = blockIdx.x, tid = threadIdx.x, lid = tid & 31,
            wid = tid >> 5;
  long long* counts = A.scratch + A.scenarios + (long long)sc * A.tiles;
  if (tid == 0) s_carry = 0;
  __syncthreads();
  for (int first = 0; first < A.tiles; first += kScanThreads) {
    const int i = first + tid;
    const long long v = i < A.tiles ? counts[i] : 0;
    long long x = v;  // inclusive scan within the warp
#pragma unroll
    for (int dl = 1; dl < 32; dl <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, dl);
      if (lid >= dl) x += y;
    }
    if (lid == 31) s_warp[wid] = x;
    __syncthreads();
    long long before = s_carry;
    for (int k = 0; k < wid; ++k) before += s_warp[k];
    if (i < A.tiles) counts[i] = before + x - v;
    __syncthreads();
    if (tid == kScanThreads - 1) s_carry = before + x;
    __syncthreads();
  }
  if (tid == 0) {
    const long long total = s_carry, rem = A.remaining[sc];
    long long n_rel = total;
    if (A.dynamic) n_rel = rem <= 0 ? 0 : (total < rem ? total : rem);
    A.scratch[sc] = rem;
    A.remaining[sc] = rem - n_rel;
    const uint32_t lo = (uint32_t)A.next_lo[sc];
    const uint32_t new_lo = lo + (uint32_t)n_rel;
    A.next_out[sc] = (int64_t)new_lo;
    A.next_out[A.scenarios + sc] =
        (int64_t)((uint32_t)A.next_hi[sc] + (new_lo < lo ? 1u : 0u));
  }
}

// --- RELAUNCH: each candidate below the budget takes the next id ---
__global__ void __launch_bounds__(kThreads)
    relaunch_kernel(const __grid_constant__ Args A) {
  __shared__ int s_warp[kWarps];
  __shared__ long long s_w[kWarps];
  const int sc = blockIdx.y, tid = threadIdx.x, lid = tid & 31,
            wid = tid >> 5;
  const int local = blockIdx.x * kThreads + tid;
  const long long lane = (long long)sc * A.n + local;
  const bool c = local < A.n && candidate(A, lane);
  const unsigned bits = __ballot_sync(0xffffffffu, c);
  if (lid == 0) s_warp[wid] = __popc(bits);
  __syncthreads();
  long long rank =
      A.scratch[A.scenarios + (long long)sc * A.tiles + blockIdx.x];
  for (int k = 0; k < wid; ++k) rank += s_warp[k];
  rank += __popc(bits & ((1u << lid) - 1u));
  long long fixed = 0;
  if (c && (!A.dynamic || rank < A.scratch[sc]))
    fixed = relaunch_lane(A, sc, lane, rank);
#pragma unroll
  for (int dl = 16; dl > 0; dl >>= 1)
    fixed += __shfl_down_sync(0xffffffffu, fixed, dl);
  if (lid == 0) s_w[wid] = fixed;
  __syncthreads();
  if (tid == 0) {
    long long sum = 0;
    for (int k = 0; k < kWarps; ++k) sum += s_w[k];
    const u64 u = (u64)sum;
    if (u != 0ull) atomicAdd(A.launched_w + sc, u);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   ptrs:  pos, dir, ivox, w, s_left, t, rng, alive, remaining, launched,
//          quota, next_lo, next_hi, seeds, launched_w, next_out, scratch,
//          ppath, lane_ids, params (5); ppath, lane_ids and the params
//          past the source's keys may be null
//   ints:  n, scenarios, tiles, threads, dynamic, kind, optional, n_media,
//          rows, cols, nx, ny, nz
// The lane arrays hold scenarios * n lanes, scenario-major; scratch
// holds scenarios * (tiles + 1) int64.  Returns the cudaError_t of the
// launches (0 on success), or cudaErrorInvalidValue when threads is not
// the block size, tiles do not cover the lanes, scenarios is outside
// [1, 65535] or kind names no source type.
extern "C" int regenerate_launch(const void* const* ptrs, const int* ints,
                                 void* stream) {
  Args a = {};
  a.pos = (float*)ptrs[0];
  a.dir = (float*)ptrs[1];
  a.ivox = (int32_t*)ptrs[2];
  a.w = (float*)ptrs[3];
  a.s_left = (float*)ptrs[4];
  a.t = (float*)ptrs[5];
  a.rng = (int64_t*)ptrs[6];
  a.alive = (uint8_t*)ptrs[7];
  a.remaining = (int64_t*)ptrs[8];
  a.launched = (int64_t*)ptrs[9];
  a.quota = (const int64_t*)ptrs[10];
  a.next_lo = (const int64_t*)ptrs[11];
  a.next_hi = (const int64_t*)ptrs[12];
  a.seeds = (const int64_t*)ptrs[13];
  a.launched_w = (u64*)ptrs[14];
  a.next_out = (int64_t*)ptrs[15];
  a.scratch = (long long*)ptrs[16];
  a.ppath = (float*)ptrs[17];
  a.lane_ids = (int64_t*)ptrs[18];
  for (int i = 0; i < kParams; ++i) a.prm[i] = (const float*)ptrs[19 + i];
  a.n = ints[0];
  a.scenarios = ints[1];
  a.tiles = ints[2];
  const int threads = ints[3];
  a.dynamic = ints[4];
  a.kind = ints[5];
  a.optional = ints[6];
  a.n_media = ints[7];
  a.rows = ints[8];
  a.cols = ints[9];
  a.nx = ints[10];
  a.ny = ints[11];
  a.nz = ints[12];
  if (threads != kThreads || a.n < 0 || a.tiles < 0 ||
      (long long)a.tiles * kThreads < a.n || a.scenarios < 1 ||
      a.scenarios > 65535 || a.kind < kPencil || a.kind > kLine)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.tiles > 0) {
    count_kernel<<<dim3(a.tiles, a.scenarios), kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  scan_kernel<<<a.scenarios, kScanThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.tiles == 0) return (int)err;
  relaunch_kernel<<<dim3(a.tiles, a.scenarios), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's compile-time block size and fixed-point shift of the
// launched weight, which the wrapper checks against its own.
extern "C" int regenerate_threads() { return kThreads; }
extern "C" int regenerate_total_shift() { return kTotalShift; }

extern "C" const char* regenerate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
