// Photon-step kernel for the host CPU: K hop-drop-spin transport
// segments per photon lane, with fluence, exitance and escaped /
// timed-out weight accumulated in the kernel, and every optional output
// group, the counterpart of csrc/photon_step.cu for CPU tensors.
//
// Replaces: the TPU kernel repro/kernels/photon_step/photon_step.py,
//   photon_step_pallas (its pallas_call, body _kernel), on the CPU
//   device of a heterogeneous fleet, every output group:
//     base      state, fluence, exitance, escaped, timed   (always)
//     DET       ppath, det_w (TPSF), det_ppath             (n_det > 0)
//     RECORD    cap_det, cap_gate                          (record)
//     JAC       jac, the replay Jacobian                   (jac_cols > 0)
//     STATS     (n, 2) segments entered alive, deposit     (stats)
//   One library holds every group: the groups are flags of the launch
//   (a branch a segment that the predictor always gets right), not
//   compile-time variants.
//
// How it runs.  Lanes are cut into blocks of kBlock lanes of one
//   scenario, and torch's intra-op threads each take the next block
//   until none is left, in an at::parallel_for (torch's own OpenMP
//   runtime: the library is compiled with -fopenmp and linked against
//   the runtime torch loaded, never a second one).  A block advances its live lanes one segment at
//   a time, in stages; between two stages each transcendental the
//   segment needs (log, exp, sqrt, sin, cos) is evaluated for all the
//   block's lanes that need it by one call.  A lane that dies leaves the
//   block's live list, and the block stops once the list is empty.
//
// Why blocks.  PyTorch's CPU float32 log, exp, sin, cos and sqrt are
//   MKL's VML functions (vmsLn, vmsExp, vmsSin, vmsCos, vmsSqrt, in
//   at::vml, at VML_HA), not libm and not the Sleef functions of
//   at::vec, and their bits differ from both (sqrt too: VML_HA is not
//   correctly rounded).  Called here on the same values they give the
//   same bits, whatever the array's length or the element's place in it,
//   but each call has a fixed cost however few values it gets, so a
//   block makes one call a transcendental and stage for all its lanes.
//   A torch built without MKL evaluates at::vml's own fallback,
//   at::vec::map with the Vectorized<float> function, and so does this
//   kernel (the build flags select the CPU capability torch dispatches
//   to).
//
// Order-independent sums.  Fluence, exitance, TPSF, detector path sums
//   and the replay Jacobian are int64 fixed point (spec.FIXED_SHIFT):
//   each deposit is rounded once to a whole number of 2^-s units
//   (nearbyint of v * 2^s, ties to even, as torch.round) and added with
//   an integer atomic (fluence and exitance summed first in the launch
//   thread's deposit cache), so a grid has the same bits at any thread
//   count and equals the plain version's.  A deposit of 2^44 units or more, or
//   not finite, adds nothing and sets the overflow bit of the error
//   word; so does an add that leaves a cell negative (a sum past
//   2^63 - 1 units), as the plain version raises for a negative cell.
//
// Parity: each lane's arithmetic follows repro_torch/core/photon.py and
//   repro_torch/detectors operation by operation, in the order of the
//   CUDA kernel (which the plain version's tests hold bit-equal on the
//   card).  Build with -ffp-contract=off and without fast math.  Every
//   division is an IEEE division, as ATen's CPU division is (also by a
//   0-dim tensor).  A dead lane only draws: it leaves the loop, and its
//   RNG words are moved past the 5 draws of each remaining segment at
//   the end of the launch (by xorshift128's GF(2) jump matrices past 64
//   draws), as rng.skip does.

#include <ATen/Config.h>
#include <ATen/Parallel.h>
#include <ATen/cpu/vec/functional.h>
#include <ATen/cpu/vec/vec.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <memory>

#if AT_PARALLEL_OPENMP && !defined(_OPENMP)
#error "torch's intra-op backend is OpenMP: compile with -fopenmp"
#endif

#if AT_MKL_ENABLED()
// MKL's VML functions as at::vml calls them (vm<s><Op>(n, in, out,
// mode)); n is MKL_INT, passed as 64 bits so LP64 and ILP64 read it.
extern "C" {
void vmsLn(long long n, const float* a, float* r, long long mode);
void vmsExp(long long n, const float* a, float* r, long long mode);
void vmsSin(long long n, const float* a, float* r, long long mode);
void vmsCos(long long n, const float* a, float* r, long long mode);
void vmsSqrt(long long n, const float* a, float* r, long long mode);
}
#endif

namespace {

constexpr float kDirEps = 1e-9f;
constexpr float kInf = 1e30f;
constexpr float kSegMin = 1e-6f;          // float32(1e-4 * 0.01)
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kCLight = 299.792458f;    // mm/ns
constexpr float kU24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kZExitFace = 0.25f;

// Lanes a block advances together: its transcendentals take one call
// each a segment.
constexpr int kBlock = 128;

// Fixed point of the order-independent grids (spec.FIXED_SHIFT).
constexpr float kWeightScale = 68719476736.0f;  // 2^36
constexpr float kPathScale = 268435456.0f;      // 2^28
constexpr float kJacScale = 68719476736.0f;     // 2^36, weight * mm
constexpr float kDepositLimit = 17592186044416.0f;  // 2^44
// Bits of the error word (photon_step.ERR_JAC_COL, ERR_OVERFLOW).
constexpr int kErrJacCol = 1, kErrOverflow = 2;
constexpr int kGroupDet = 1, kGroupRecord = 2, kGroupJac = 4,
              kGroupStats = 8;
// Return codes of the entry point besides 0.
constexpr int kBadArguments = 1, kFailed = 2;

// --- MATH: what ATen's CPU float32 operators compute ---
#if AT_MKL_ENABLED()
// VML_HA | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE, at::vml's mode
constexpr long long kVmlMode = 0x2 | 0x140000 | 0x100;
void v_log(float* r, const float* a, int n) { vmsLn(n, a, r, kVmlMode); }
void v_exp(float* r, const float* a, int n) { vmsExp(n, a, r, kVmlMode); }
void v_sin(float* r, const float* a, int n) { vmsSin(n, a, r, kVmlMode); }
void v_cos(float* r, const float* a, int n) { vmsCos(n, a, r, kVmlMode); }
void v_sqrt(float* r, const float* a, int n) { vmsSqrt(n, a, r, kVmlMode); }
constexpr int kMathMkl = 1;
#else
using Vec = at::vec::Vectorized<float>;
void v_log(float* r, const float* a, int n) {
  at::vec::map([](Vec x) { return x.log(); }, r, a, n);
}
void v_exp(float* r, const float* a, int n) {
  at::vec::map([](Vec x) { return x.exp(); }, r, a, n);
}
void v_sin(float* r, const float* a, int n) {
  at::vec::map([](Vec x) { return x.sin(); }, r, a, n);
}
void v_cos(float* r, const float* a, int n) {
  at::vec::map([](Vec x) { return x.cos(); }, r, a, n);
}
void v_sqrt(float* r, const float* a, int n) {
  at::vec::map([](Vec x) { return x.sqrt(); }, r, a, n);
}
constexpr int kMathMkl = 0;
#endif

// One transcendental for the lanes of a block that need it: the
// arguments are gathered, evaluated by one call, and each result stored
// where its lane keeps it (negated for -log).
struct Batch {
  float in[2 * kBlock], out[2 * kBlock];
  float* dst[2 * kBlock];
  int n = 0;
  void add(float x, float* d) {
    in[n] = x;
    dst[n] = d;
    ++n;
  }
  void run(void (*f)(float*, const float*, int), bool negate = false) {
    if (n == 0) return;
    f(out, in, n);
    for (int j = 0; j < n; ++j) *dst[j] = negate ? -out[j] : out[j];
    n = 0;
  }
};

// --- RNG: xorshift128 on native words, and its jump ahead ---
struct Rng {
  uint32_t x, y, z, w;
  float uniform() {
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

// The state as 128 bits: (x | y << 32, z | w << 32).
struct Bits {
  uint64_t lo, hi;
};

Bits step_bits(Bits v) {
  Rng r{(uint32_t)v.lo, (uint32_t)(v.lo >> 32), (uint32_t)v.hi,
        (uint32_t)(v.hi >> 32)};
  r.uniform();
  return {r.x | ((uint64_t)r.y << 32), r.z | ((uint64_t)r.w << 32)};
}

// Columns of the GF(2) matrices of 2^k xorshift128 steps, k < kJumpLevels:
// the step is linear in the state's bits, so 2^k steps of a state are
// the XOR of the columns of its set bits.
constexpr int kJumpLevels = 16;  // past spec.MAX_STEPS * 5 draws
struct JumpTable {
  Bits col[kJumpLevels][128];
  JumpTable() {
    for (int j = 0; j < 128; ++j) {
      const Bits e{j < 64 ? 1ull << j : 0ull, j < 64 ? 0ull : 1ull << (j - 64)};
      col[0][j] = step_bits(e);
    }
    for (int k = 1; k < kJumpLevels; ++k)
      for (int j = 0; j < 128; ++j) col[k][j] = apply(k - 1, col[k - 1][j]);
  }
  Bits apply(int k, Bits v) const {
    Bits r{0, 0};
    for (int j = 0; j < 128; ++j) {
      const uint64_t bit = j < 64 ? (v.lo >> j) & 1 : (v.hi >> (j - 64)) & 1;
      if (bit) {
        r.lo ^= col[k][j].lo;
        r.hi ^= col[k][j].hi;
      }
    }
    return r;
  }
};

const JumpTable& jump_table() {
  static const JumpTable table;
  return table;
}

// The lane's RNG after `draws` more draws.
void skip(Rng& r, long long draws) {
  if (draws < 64) {
    for (long long j = 0; j < draws; ++j) r.uniform();
    return;
  }
  const JumpTable& table = jump_table();
  Bits v{r.x | ((uint64_t)r.y << 32), r.z | ((uint64_t)r.w << 32)};
  for (int k = 0; draws != 0; ++k, draws >>= 1)
    if (draws & 1) v = table.apply(k, v);
  r = Rng{(uint32_t)v.lo, (uint32_t)(v.lo >> 32), (uint32_t)v.hi,
          (uint32_t)(v.hi >> 32)};
}

void flag(int* errors, int bit) {
  __atomic_fetch_or(errors, bit, __ATOMIC_RELAXED);
}

int clampi(long long v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : (int)v);
}

// floor(v) as an index clamped into [0, hi], as the plain version's
// floor, int64 conversion and clamp give it for finite v.
int floor_index(float v, int hi) {
  const float f = std::floor(v);
  return f < 0.f ? 0 : (f >= (float)hi ? hi : (int)f);
}

float signf(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

// v in fixed point (v * scale rounded to nearest even) in *u; false,
// with the overflow bit set, for a deposit of 2^44 units or more, or
// not finite.
bool to_fixed(float v, float scale, int* errors, int64_t* u) {
  const float x = v * scale;
  if (!(x < kDepositLimit)) {
    flag(errors, kErrOverflow);
    return false;
  }
  *u = (int64_t)std::nearbyint(x);
  return true;
}

// Adds u units to *cell with an integer atomic; a sum that leaves the
// cell negative (past 2^63 - 1 units) sets the overflow bit.
void add_units(int64_t* cell, uint64_t u, int* errors) {
  const uint64_t old = __atomic_fetch_add((uint64_t*)cell, u,
                                          __ATOMIC_RELAXED);
  if ((int64_t)(old + u) < 0) flag(errors, kErrOverflow);
}

// Adds v in fixed point to *cell.
void add_fixed(int64_t* cell, float v, float scale, int* errors) {
  int64_t u;
  if (to_fixed(v, scale, errors, &u) && u != 0)
    add_units(cell, (uint64_t)u, errors);
}

// Deposit cache of a launch thread: kCacheSlots (cell, sum) pairs,
// direct-mapped by a multiplicative hash of the cell's address, summed
// over every block the thread runs and added to the grids once at its
// end.  A pencil source puts most deposits of a launch into a few
// cells, and an atomic add on a cache line that another core holds
// waits for the line; summed here first, the hottest cell takes one
// atomic a thread instead of one a deposit.  A deposit whose slot holds
// another cell adds to its cell at once.  The sums are integers, so
// the grids' bits do not change.
constexpr int kCacheLog2 = 12;
constexpr int kCacheSlots = 1 << kCacheLog2;
struct DepositCache {
  int64_t* cell[kCacheSlots] = {};
  uint64_t sum[kCacheSlots] = {};
  void add(int64_t* c, float v, float scale, int* errors) {
    int64_t u;
    if (!to_fixed(v, scale, errors, &u) || u == 0) return;
    const int slot = (int)((((uintptr_t)c >> 3) * 0x9E3779B97F4A7C15ull) >>
                           (64 - kCacheLog2));
    if (cell[slot] == c) {
      // a cached sum stays below 2^63: past it, the cell takes it first
      if ((int64_t)(sum[slot] + (uint64_t)u) < 0) {
        add_units(c, sum[slot], errors);
        sum[slot] = 0;
      }
      sum[slot] += (uint64_t)u;
    } else if (cell[slot] == nullptr) {
      cell[slot] = c;
      sum[slot] = (uint64_t)u;
    } else {
      add_units(c, (uint64_t)u, errors);
    }
  }
  void flush(int* errors) {
    for (int i = 0; i < kCacheSlots; ++i)
      if (cell[i] != nullptr && sum[i] != 0) add_units(cell[i], sum[i], errors);
  }
};

// Inputs, outputs and scalars of one launch.
struct Args {
  const uint8_t* labels;  // (nvox), or (S, nvox) with labels_stride nvox
  const float* media;     // (S, n_media, 4)
  const float* pos_in;
  const float* dir_in;
  const int32_t* ivox_in;
  const float* w_in;
  const float* s_in;
  const float* t_in;
  const int64_t* rng_in;
  const uint8_t* alive_in;
  int* errors;             // kErrJacCol | kErrOverflow, ORed in
  const float* ppath_in;   // DET (n, n_media)
  const float* det_geom;   // DET (S, n_det, 3): x, y, radius^2
  const float* jac_w;      // JAC (n,)
  const int32_t* jac_col;  // JAC (n,)
  float* pos_out;
  float* dir_out;
  int32_t* ivox_out;
  float* w_out;
  float* s_out;
  float* t_out;
  int64_t* rng_out;
  uint8_t* alive_out;
  int64_t* fluence;   // (S, nvox * ntg), 2^-36 weight units
  int64_t* exitance;  // (S, nx * ny), 2^-36 weight units
  float* esc_out;
  float* timed_out;
  float* ppath_out;   // DET (n, n_media)
  int64_t* det_w;     // DET (S, n_det * ntg), 2^-36 weight units
  int64_t* det_ppath; // DET (S, n_det, n_media), 2^-28 weight * mm
  int32_t* cap_det;   // RECORD (n,)
  int32_t* cap_gate;  // RECORD (n,)
  int64_t* jac;       // JAC (S, nvox * jac_cols), 2^-36 weight * mm
  float* stats;       // STATS (n, 2)
  long long labels_stride;
  int n, nx, ny, nz, n_steps, ntg, n_det, n_media, jac_cols;
  bool general_exact, do_reflect, taylor, det, record, use_jac, use_stats;
  float unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p;
};

// What kind of direction change a lane's segment makes.
enum Turn : uint8_t { kKeep = 0, kScatter = 1, kFresnel = 2 };

// A block's lanes (their state while it runs) and the values of the
// current segment that cross a stage.
struct Block {
  // lane state
  float p[kBlock][3], d[kBlock][3];
  int iv[kBlock][3];
  float w[kBlock], s[kBlock], t[kBlock];
  Rng r[kBlock];
  int steps[kBlock];  // segments entered alive (5 draws each)
  bool alive[kBlock];
  float esc_acc[kBlock], timed_acc[kBlock], st_live[kBlock], st_dep[kBlock];
  int cap_det[kBlock], cap_gate[kBlock];
  float jac_w[kBlock];
  int jac_col[kBlock];
  float* pp[kBlock];
  int live[kBlock];
  // the segment
  int flat[kBlock], label[kBlock], axis[kBlock], nv[kBlock][3];
  float mua[kBlock], mus[kBlock], g[kBlock], n_cur[kBlock];
  float u_cos[kBlock], u_phi[kBlock], u_fres[kBlock], u_roul[kBlock];
  float s_new[kBlock], seg[kBlock], np_[kBlock][3], t_new[kBlock];
  float e[kBlock], dep[kBlock], w_after[kBlock];
  bool hits_wall[kBlock], oob[kBlock], reflects[kBlock];
  int next_label[kBlock];
  Turn turn[kBlock];
  float cost[kBlock], sint[kBlock], sinp[kBlock], cosp[kBlock], tmp[kBlock];
  float eta[kBlock], sin2_t[kBlock], cos_t[kBlock], nd[kBlock][3],
      norm[kBlock];
  Batch b_log, b_exp, b_sqrt, b_sin, b_cos;
};

// Lanes [first, first + count) of scenario sc, n_steps segments.
void run_block(const Args& A, Block& B, DepositCache& cache, const int sc,
               const long long first, const int count) {
  // --- LANE: the block's state in ---
  const int nx = A.nx, ny = A.ny, nz = A.nz, ntg = A.ntg, nm = A.n_media;
  const int nvox = nx * ny * nz, n_flu = nvox * ntg;
  const uint8_t* labels = A.labels + sc * A.labels_stride;
  const float* media = A.media + (long long)sc * nm * 4;
  int64_t* fluence = A.fluence + (long long)sc * n_flu;
  int64_t* exitance = A.exitance + (long long)sc * nx * ny;
  const float* det_geom = nullptr;
  int64_t* det_w = nullptr;
  int64_t* det_ppath = nullptr;
  if (A.det) {
    det_geom = A.det_geom + (long long)sc * A.n_det * 3;
    det_w = A.det_w + (long long)sc * A.n_det * ntg;
    det_ppath = A.det_ppath + (long long)sc * A.n_det * nm;
  }
  int64_t* jac = A.use_jac ? A.jac + (long long)sc * nvox * A.jac_cols
                           : nullptr;
  int m = 0;
  for (int i = 0; i < count; ++i) {
    const long long lane = first + i;
    for (int a = 0; a < 3; ++a) {
      B.p[i][a] = A.pos_in[3 * lane + a];
      B.d[i][a] = A.dir_in[3 * lane + a];
      B.iv[i][a] = A.ivox_in[3 * lane + a];
    }
    B.w[i] = A.w_in[lane];
    B.s[i] = A.s_in[lane];
    B.t[i] = A.t_in[lane];
    B.r[i] = Rng{(uint32_t)A.rng_in[4 * lane + 0],
                 (uint32_t)A.rng_in[4 * lane + 1],
                 (uint32_t)A.rng_in[4 * lane + 2],
                 (uint32_t)A.rng_in[4 * lane + 3]};
    B.steps[i] = 0;
    B.alive[i] = A.alive_in[lane] != 0;
    B.esc_acc[i] = B.timed_acc[i] = B.st_live[i] = B.st_dep[i] = 0.f;
    B.cap_det[i] = -1;
    B.cap_gate[i] = 0;
    if (A.det) {
      // the lane's per-medium path, carried in its row of ppath_out (the
      // same row when the launch writes in place: no copy, which would
      // overlap)
      B.pp[i] = A.ppath_out + lane * nm;
      if (A.ppath_in != A.ppath_out)
        std::memcpy(B.pp[i], A.ppath_in + lane * nm, sizeof(float) * nm);
    }
    if (A.use_jac) {
      B.jac_w[i] = A.jac_w[lane];
      B.jac_col[i] = A.jac_col[lane];
      // a column outside the grid adds nothing and flags the launch
      if ((unsigned)B.jac_col[i] >= (unsigned)A.jac_cols) {
        flag(A.errors, kErrJacCol);
        B.jac_w[i] = 0.f;
        B.jac_col[i] = 0;
      }
    }
    if (B.alive[i]) B.live[m++] = i;
  }

  for (int k = 0; k < A.n_steps && m > 0; ++k) {
    // --- LOOKUP and UNIFORMS: always 5 a segment ---
    for (int j = 0; j < m; ++j) {
      const int i = B.live[j];
      const int cx = clampi(B.iv[i][0], 0, nx - 1);
      const int cy = clampi(B.iv[i][1], 0, ny - 1);
      const int cz = clampi(B.iv[i][2], 0, nz - 1);
      B.flat[i] = (cx * ny + cy) * nz + cz;
      const int label = labels[B.flat[i]];
      B.label[i] = label;
      B.mua[i] = media[4 * label + 0] * A.unit;
      B.mus[i] = media[4 * label + 1] * A.unit;
      B.g[i] = media[4 * label + 2];
      B.n_cur[i] = media[4 * label + 3];
      Rng& r = B.r[i];
      const float u_path = r.uniform();
      B.u_cos[i] = r.uniform();
      B.u_phi[i] = r.uniform();
      B.u_fres[i] = r.uniform();
      B.u_roul[i] = r.uniform();
      B.steps[i] += 1;
      if (B.s[i] <= 0.f)
        B.b_log.add(u_path, &B.s_new[i]);
      else
        B.s_new[i] = B.s[i];
    }
    B.b_log.run(v_log, /*negate=*/true);

    // --- HOP ---
    for (int j = 0; j < m; ++j) {
      const int i = B.live[j];
      const float* p = B.p[i];
      const float* d = B.d[i];
      float dist[3];
      for (int a = 0; a < 3; ++a) {
        const float fv = (float)B.iv[i][a];
        const float num = d[a] > kDirEps ? (fv + 1.f) - p[a] : fv - p[a];
        const float q = num / d[a];
        dist[a] = std::fmax(std::fabs(d[a]) > kDirEps ? q : kInf, 0.f);
      }
      B.axis[i] = (dist[0] <= dist[1] && dist[0] <= dist[2])
                      ? 0 : (dist[1] <= dist[2] ? 1 : 2);
      const float d_wall = std::fmin(std::fmin(dist[0], dist[1]), dist[2]);
      const float mus = B.mus[i];
      float d_scat = B.s_new[i] / std::fmax(mus, kDirEps);
      if (mus <= kDirEps) d_scat = kInf;
      const bool hits_wall = d_wall < d_scat;
      B.hits_wall[i] = hits_wall;
      const float seg = std::fmax(hits_wall ? d_wall : d_scat, kSegMin);
      B.seg[i] = seg;
      for (int a = 0; a < 3; ++a) B.np_[i][a] = p[a] + d[a] * seg;
      B.s_new[i] = hits_wall ? B.s_new[i] - seg * mus : 0.f;
      B.t_new[i] = B.t[i] + seg * A.unit * B.n_cur[i] / kCLight;
      const float tau = B.mua[i] * seg;
      if (A.taylor) {
        B.e[i] = tau;
      } else {
        B.b_exp.add(-tau, &B.e[i]);
      }
    }
    B.b_exp.run(v_exp);

    // --- DROP, the next voxel, and the arguments of SPIN / Fresnel ---
    for (int j = 0; j < m; ++j) {
      const int i = B.live[j];
      const float w = B.w[i];
      if (A.taylor) {
        B.dep[i] = w * std::fmin(B.e[i], 1.f);
        B.w_after[i] = w - B.dep[i];
      } else if (A.general_exact) {
        B.dep[i] = w - w * B.e[i];
        B.w_after[i] = w - B.dep[i];
      } else {
        B.w_after[i] = w * B.e[i];
        B.dep[i] = w - B.w_after[i];
      }
      const float* d = B.d[i];
      const int axis = B.axis[i];
      const float dir_axis = d[axis];
      const int sgn = dir_axis > 0.f ? 1 : (dir_axis < 0.f ? -1 : 0);
      int* nv = B.nv[i];
      for (int a = 0; a < 3; ++a) nv[a] = B.iv[i][a] + (a == axis ? sgn : 0);
      const bool oob = nv[0] < 0 || nv[0] >= nx || nv[1] < 0 || nv[1] >= ny ||
                       nv[2] < 0 || nv[2] >= nz;
      B.oob[i] = oob;
      B.next_label[i] = oob ? 0 : labels[(nv[0] * ny + nv[1]) * nz + nv[2]];
      B.turn[i] = kKeep;
      B.reflects[i] = false;
      if (!B.hits_wall[i]) {
        // Henyey-Greenstein (MCML rotation formulas)
        B.turn[i] = kScatter;
        const float g = B.g[i], u_cos = B.u_cos[i];
        const bool small_g = std::fabs(g) < 1e-5f;
        const float gs = small_g ? 1.f : g;
        const float frac = (1.f - gs * gs) / (1.f - gs + 2.f * gs * u_cos);
        const float cost_hg = (1.f + gs * gs - frac * frac) / (2.f * gs);
        float cost = small_g ? 2.f * u_cos - 1.f : cost_hg;
        cost = std::fmin(std::fmax(cost, -1.f), 1.f);
        B.cost[i] = cost;
        B.b_sqrt.add(std::fmax(1.f - cost * cost, 0.f), &B.sint[i]);
        const float phi = kTwoPi * B.u_phi[i];
        B.b_sin.add(phi, &B.sinp[i]);
        B.b_cos.add(phi, &B.cosp[i]);
        const float uz = d[2];
        if (!(std::fabs(uz) > 0.99999f))
          B.b_sqrt.add(std::fmax(1.f - uz * uz, 1e-12f), &B.tmp[i]);
      } else if (A.do_reflect) {
        // Fresnel reflection / Snell refraction, only where the index
        // changes: without a mismatch the direction stays as it is
        const float n_cur = B.n_cur[i];
        const float n_next = media[4 * B.next_label[i] + 3];
        if (std::fabs(n_next - n_cur) > 1e-6f) {
          B.turn[i] = kFresnel;
          const float cos_i = std::fmin(std::fmax(std::fabs(dir_axis), 0.f),
                                        1.f);
          const float eta = n_cur / std::fmax(n_next, 1e-6f);
          const float sin2_t =
              eta * eta * std::fmax(1.f - cos_i * cos_i, 0.f);
          B.eta[i] = eta;
          B.sin2_t[i] = sin2_t;
          B.b_sqrt.add(std::fmax(1.f - sin2_t, 0.f), &B.cos_t[i]);
        }
      }
    }
    B.b_sqrt.run(v_sqrt);
    B.b_sin.run(v_sin);
    B.b_cos.run(v_cos);

    // --- SPIN and the Fresnel choice: the new direction, unnormalised ---
    for (int j = 0; j < m; ++j) {
      const int i = B.live[j];
      const float* d = B.d[i];
      float* nd = B.nd[i];
      if (B.turn[i] == kScatter) {
        const float sint = B.sint[i], cosp = B.cosp[i], sinp = B.sinp[i];
        const float cost = B.cost[i];
        const float ux = d[0], uy = d[1], uz = d[2];
        if (std::fabs(uz) > 0.99999f) {
          nd[0] = sint * cosp;
          nd[1] = sint * sinp;
          nd[2] = cost * signf(uz);
        } else {
          const float tmp = B.tmp[i];
          nd[0] = sint * (ux * uz * cosp - uy * sinp) / tmp + ux * cost;
          nd[1] = sint * (uy * uz * cosp + ux * sinp) / tmp + uy * cost;
          nd[2] = -sint * cosp * tmp + uz * cost;
        }
        B.b_sqrt.add(nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2],
                     &B.norm[i]);
      } else if (B.turn[i] == kFresnel) {
        const float n_cur = B.n_cur[i];
        const float n_next = media[4 * B.next_label[i] + 3];
        const int axis = B.axis[i];
        const float cos_i = std::fmin(std::fmax(std::fabs(d[axis]), 0.f), 1.f);
        const float cos_t = B.cos_t[i];
        const bool tir = B.sin2_t[i] >= 1.f;
        const float rs_num = n_cur * cos_i - n_next * cos_t;
        const float rs_den = n_cur * cos_i + n_next * cos_t;
        const float rp_num = n_cur * cos_t - n_next * cos_i;
        const float rp_den = n_cur * cos_t + n_next * cos_i;
        const float rs = rs_num / (std::fabs(rs_den) < 1e-12f ? 1.f : rs_den);
        const float rp = rp_num / (std::fabs(rp_den) < 1e-12f ? 1.f : rp_den);
        const float refl_r = std::fmin(
            std::fmax(tir ? 1.f : 0.5f * (rs * rs + rp * rp), 0.f), 1.f);
        const bool reflects = B.u_fres[i] < refl_r;
        B.reflects[i] = reflects;
        if (reflects) {
          for (int a = 0; a < 3; ++a) nd[a] = a == axis ? d[a] * -1.f : d[a];
        } else {
          const float sgnf = d[axis] > 0.f ? 1.f : (d[axis] < 0.f ? -1.f : 0.f);
          const float eta = B.eta[i];
          for (int a = 0; a < 3; ++a) {
            const float af = a == axis ? 1.f : 0.f;
            nd[a] = d[a] * (1.f - af) * eta + af * (sgnf * cos_t);
          }
          B.b_sqrt.add(nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2],
                       &B.norm[i]);
        }
      }
    }
    B.b_sqrt.run(v_sqrt);

    // --- ROULETTE, the time gate, DEPOSIT, capture, the state update ---
    int kept = 0;
    for (int j = 0; j < m; ++j) {
      const int i = B.live[j];
      float* nd = B.nd[i];
      if (B.turn[i] == kScatter ||
          (B.turn[i] == kFresnel && !B.reflects[i])) {
        const float norm = std::fmax(B.norm[i], 1e-12f);
        for (int a = 0; a < 3; ++a) nd[a] = nd[a] / norm;
      } else if (B.turn[i] == kKeep) {
        for (int a = 0; a < 3; ++a) nd[a] = B.d[i][a];
      }
      const bool crossing = B.hits_wall[i];
      const bool reflects = B.reflects[i];
      const bool escapes =
          crossing && !reflects && (B.oob[i] || B.next_label[i] == 0);
      const bool advances = crossing && !reflects && !escapes;
      const float w_after = B.w_after[i], dep = B.dep[i];
      const float t_new = B.t_new[i];
      bool alive_after = !escapes;
      const bool low_w = alive_after && (w_after < A.w_threshold);
      const bool survives = B.u_roul[i] < A.roulette_p;
      float w_final =
          low_w ? (survives ? w_after * A.roulette_m : 0.f) : w_after;
      alive_after = alive_after && !(low_w && !survives);
      const bool gate_kill = alive_after && (t_new > A.tmax);
      alive_after = alive_after && !gate_kill;
      const float timed_w = gate_kill ? w_final : 0.f;
      const float esc_w = escapes ? w_after : 0.f;
      if (escapes) w_final = 0.f;

      if (A.use_stats) {
        B.st_live[i] = B.st_live[i] + 1.f;
        B.st_dep[i] = B.st_dep[i] + dep;
      }
      const float* np_ = B.np_[i];
      if (dep != 0.f) {
        const int gate = floor_index(t_new * A.gate_scale, ntg - 1);
        cache.add(fluence + (long long)B.flat[i] * ntg + gate, dep,
                  kWeightScale, A.errors);
      }
      const float seg_len = B.seg[i] * A.unit;
      const bool z_exit = esc_w > 0.f && np_[2] < kZExitFace;
      if (A.det) {
        // the segment's path joins the lane's medium sum before the
        // capture test, so a detected photon carries its last segment
        float* pp = B.pp[i];
        pp[B.label[i]] = pp[B.label[i]] + seg_len;
        if (z_exit) {
          int det = -1;  // the first disk that holds the exit point
          for (int dd = 0; dd < A.n_det; ++dd) {
            const float dx = np_[0] - det_geom[3 * dd + 0];
            const float dy = np_[1] - det_geom[3 * dd + 1];
            if (dx * dx + dy * dy <= det_geom[3 * dd + 2]) {
              det = dd;
              break;
            }
          }
          if (det >= 0) {
            const int gate = floor_index(t_new * A.gate_scale, ntg - 1);
            add_fixed(det_w + det * ntg + gate, esc_w, kWeightScale,
                      A.errors);
            for (int md = 0; md < nm; ++md)
              add_fixed(det_ppath + det * nm + md, esc_w * pp[md], kPathScale,
                        A.errors);
            if (A.record) {
              B.cap_det[i] = det;
              B.cap_gate[i] = gate;
            }
          }
        }
      }
      if (A.use_jac)
        add_fixed(jac + (long long)B.flat[i] * A.jac_cols + B.jac_col[i],
                  B.jac_w[i] * seg_len, kJacScale, A.errors);
      if (z_exit) {
        const int ex = floor_index(np_[0], nx - 1);
        const int ey = floor_index(np_[1], ny - 1);
        cache.add(exitance + ex * ny + ey, esc_w, kWeightScale, A.errors);
      }
      B.esc_acc[i] = B.esc_acc[i] + esc_w;
      B.timed_acc[i] = B.timed_acc[i] + timed_w;
      for (int a = 0; a < 3; ++a) {
        B.p[i][a] = np_[a];
        B.d[i][a] = nd[a];
      }
      if (advances)
        for (int a = 0; a < 3; ++a) B.iv[i][a] = B.nv[i][a];
      B.w[i] = w_final;
      B.s[i] = B.s_new[i];
      B.t[i] = t_new;
      B.alive[i] = alive_after;
      if (alive_after) B.live[kept++] = i;
    }
    m = kept;
  }

  // --- WRITE-BACK: dead lanes' RNG past their remaining draws ---
  for (int i = 0; i < count; ++i) {
    const long long lane = first + i;
    skip(B.r[i], 5LL * (A.n_steps - B.steps[i]));
    for (int a = 0; a < 3; ++a) {
      A.pos_out[3 * lane + a] = B.p[i][a];
      A.dir_out[3 * lane + a] = B.d[i][a];
      A.ivox_out[3 * lane + a] = B.iv[i][a];
    }
    A.w_out[lane] = B.w[i];
    A.s_out[lane] = B.s[i];
    A.t_out[lane] = B.t[i];
    A.rng_out[4 * lane + 0] = (int64_t)B.r[i].x;
    A.rng_out[4 * lane + 1] = (int64_t)B.r[i].y;
    A.rng_out[4 * lane + 2] = (int64_t)B.r[i].z;
    A.rng_out[4 * lane + 3] = (int64_t)B.r[i].w;
    A.alive_out[lane] = B.alive[i] ? 1 : 0;
    A.esc_out[lane] = B.esc_acc[i];
    A.timed_out[lane] = B.timed_acc[i];
    if (A.record) {
      A.cap_det[lane] = B.cap_det[i];
      A.cap_gate[lane] = B.cap_gate[i];
    }
    if (A.use_stats) {
      A.stats[2 * lane + 0] = B.st_live[i];
      A.stats[2 * lane + 1] = B.st_dep[i];
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes; the arrays of the CUDA entry
// point (photon_step.prepare and pack build both).
//   in:  labels, media, pos, dir, ivox, w, s_left, t, rng, alive, errors
//        (11), then [ppath, det_geom] (DET), [jac_w, jac_col] (JAC);
//        errors is one int32 the kernel ORs its error bits into
//   out: pos, dir, ivox, w, s_left, t, rng, alive, fluence, exitance,
//        escaped, timed (12), then [ppath, det_w, det_ppath] (DET),
//        [cap_det, cap_gate] (RECORD), [jac] (JAC), [stats] (STATS);
//        fluence, exitance, det_w, det_ppath and jac are int64 fixed
//        point, zeroed here unless add_into is set, when the launch adds
//        into them; the state's and ppath's out arrays may be their in
//        arrays (a block reads its lanes before it writes them)
//   ints:   n, nx, ny, nz, n_steps, ntg, general_exact, do_reflect, taylor,
//           groups, n_det, n_media, jac_cols, scenarios, labels_stride,
//           add_into, threads, blocks (the last two are the card's launch
//           plan and are not read here)
//   floats: unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p
// Returns 0, kBadArguments when ``groups`` is not a valid set (RECORD
// needs DET) or ``scenarios`` is below 1, or kFailed when a thread
// raised (photon_step_cpu_error_string says which).  The lanes run on
// torch's intra-op threads; the bits do not depend on their number.
extern "C" int photon_step_cpu_launch(const void* const* in, void* const* out,
                                      const int* ints, const float* floats) {
  const int n = ints[0], groups = ints[9], n_det = ints[10],
            n_media = ints[11], jac_cols = ints[12], scenarios = ints[13],
            labels_stride = ints[14], add_into = ints[15];
  const bool kDet = (groups & kGroupDet) != 0;
  const bool kRecord = (groups & kGroupRecord) != 0;
  const bool kJac = (groups & kGroupJac) != 0;
  const bool kStats = (groups & kGroupStats) != 0;
  if (groups < 0 || groups > 15 || (kRecord && !kDet) || scenarios < 1 ||
      n < 0)
    return kBadArguments;
  Args a = {};
  a.labels = (const uint8_t*)in[0];
  a.media = (const float*)in[1];
  a.pos_in = (const float*)in[2];
  a.dir_in = (const float*)in[3];
  a.ivox_in = (const int32_t*)in[4];
  a.w_in = (const float*)in[5];
  a.s_in = (const float*)in[6];
  a.t_in = (const float*)in[7];
  a.rng_in = (const int64_t*)in[8];
  a.alive_in = (const uint8_t*)in[9];
  a.errors = (int*)in[10];
  a.pos_out = (float*)out[0];
  a.dir_out = (float*)out[1];
  a.ivox_out = (int32_t*)out[2];
  a.w_out = (float*)out[3];
  a.s_out = (float*)out[4];
  a.t_out = (float*)out[5];
  a.rng_out = (int64_t*)out[6];
  a.alive_out = (uint8_t*)out[7];
  a.fluence = (int64_t*)out[8];
  a.exitance = (int64_t*)out[9];
  a.esc_out = (float*)out[10];
  a.timed_out = (float*)out[11];
  a.labels_stride = labels_stride;
  a.n = n;
  a.nx = ints[1];
  a.ny = ints[2];
  a.nz = ints[3];
  a.n_steps = ints[4];
  a.ntg = ints[5];
  a.general_exact = ints[6] != 0;
  a.do_reflect = ints[7] != 0;
  a.taylor = ints[8] != 0;
  a.unit = floats[0];
  a.gate_scale = floats[1];
  a.tmax = floats[2];
  a.w_threshold = floats[3];
  a.roulette_m = floats[4];
  a.roulette_p = floats[5];
  // the optional inputs and outputs follow the base ones, in the order
  // of the output contract (kernels/photon_step/spec.py)
  int i_in = 11, i_out = 12;
  if (kDet) {
    a.ppath_in = (const float*)in[i_in++];
    a.det_geom = (const float*)in[i_in++];
    a.ppath_out = (float*)out[i_out++];
    a.det_w = (int64_t*)out[i_out++];
    a.det_ppath = (int64_t*)out[i_out++];
  }
  if (kJac) {
    a.jac_w = (const float*)in[i_in++];
    a.jac_col = (const int32_t*)in[i_in++];
  }
  if (kRecord) {
    a.cap_det = (int32_t*)out[i_out++];
    a.cap_gate = (int32_t*)out[i_out++];
  }
  if (kJac) a.jac = (int64_t*)out[i_out++];
  if (kStats) a.stats = (float*)out[i_out++];
  a.det = kDet;
  a.record = kRecord;
  a.use_jac = kJac;
  a.use_stats = kStats;
  a.n_det = n_det;
  a.n_media = n_media;
  a.jac_cols = jac_cols;

  const size_t sc = (size_t)scenarios;
  const size_t nvox = (size_t)a.nx * a.ny * a.nz;
  const struct { void* p; size_t bytes; } zero[] = {
      {a.fluence, 8 * sc * nvox * a.ntg},
      {a.exitance, 8 * sc * a.nx * a.ny},
      {a.det_w, 8 * sc * n_det * a.ntg},
      {a.det_ppath, 8 * sc * n_det * n_media},
      {a.jac, 8 * sc * nvox * jac_cols}};
  for (const auto& z : zero)
    if (!add_into && z.p != nullptr && z.bytes != 0)
      std::memset(z.p, 0, z.bytes);
  if (n == 0) return 0;
  const long long per_sc = (n + kBlock - 1) / kBlock;
  const long long blocks = per_sc * scenarios;
  try {
    jump_table();  // built once, before the threads need it
    // each thread takes the next block until none is left: blocks whose
    // lanes live longer do not hold up a thread's fixed share
    long long next = 0;
    const long long threads = std::min<long long>(at::get_num_threads(),
                                                  blocks);
    at::parallel_for(0, threads, 1, [&](int64_t, int64_t) {
      std::unique_ptr<Block> block(new Block());
      std::unique_ptr<DepositCache> cache(new DepositCache());
      for (long long b = __atomic_fetch_add(&next, 1LL, __ATOMIC_RELAXED);
           b < blocks; b = __atomic_fetch_add(&next, 1LL, __ATOMIC_RELAXED)) {
        const int s = (int)(b / per_sc);
        const long long start = (b % per_sc) * kBlock;
        const int count = (int)std::min<long long>(kBlock, n - start);
        run_block(a, *block, *cache, s, (long long)s * n + start, count);
      }
      cache->flush(a.errors);
    });
  } catch (const std::exception&) {
    return kFailed;
  }
  return 0;
}

// torch's intra-op threads, which a launch from this thread runs on.
extern "C" int photon_step_cpu_threads() { return at::get_num_threads(); }

// 1 when the transcendentals are MKL's VML functions, 0 when they are
// at::vec's (a torch built without MKL).
extern "C" int photon_step_cpu_math() { return kMathMkl; }

extern "C" const char* photon_step_cpu_error_string(int code) {
  switch (code) {
    case 0: return "no error";
    case kBadArguments: return "invalid output groups or scenario count";
    case kFailed: return "a thread of the launch raised";
    default: return "unknown error";
  }
}
