// Photon-step kernel for NVIDIA Hopper (sm_90a): K hop-drop-spin
// transport segments per photon lane, with fluence, exitance and
// escaped / timed-out weight accumulated in the kernel, and the optional
// output groups as compile-time variants.
//
// Replaces: the TPU kernel repro/kernels/photon_step/photon_step.py,
//   photon_step_pallas (its pallas_call, body _kernel), every output
//   group:
//     base      state, fluence, exitance, escaped, timed   (always)
//     DET       ppath, det_w (TPSF), det_ppath             (n_det > 0)
//     RECORD    cap_det, cap_gate                          (record)
//     JAC       jac, the replay Jacobian                   (jac_cols > 0)
//     STATS     (n, 2) segments entered alive, deposit     (stats)
//   The source is compiled once per valid set of groups, with
//   -DPS_GROUPS=<mask> (1 DET, 2 RECORD, 4 JAC, 8 STATS; RECORD needs
//   DET), into a library of its own; groups that are off compile away,
//   so the base variant is the base kernel alone.
//
// What bounds it.  The source's own count, which sets the kernel
//   table's bound in chip_smoke.py, is per live lane-segment ~130
//   float32 and ~18 special-function operations and, per launch, 81 B
//   of lane state each way: 0.017 ms for a mid-run launch of 262144
//   lanes x 16 segments (special functions).  The card issues more:
//   built without fast math, each IEEE division is a reciprocal, two
//   refinements and a slow-path test, and log/exp/sin/cos are
//   polynomials.  sass.py counts the SASS by region (the "// --- NAME"
//   markers below; a static count, so branches a segment rarely takes
//   are in it): about 440 instructions on a segment that crosses a wall
//   and 640 on one that scatters, so issuing a mid-run launch takes
//   0.06-0.09 ms (chip_smoke.py's estimate from the paths the lanes
//   take).  What held the launch at 0.22-0.25 ms was neither: compiled
//   without its fluence and exitance atomics it ran in 0.45 (B1) to
//   0.75 (detection forward) of the time.  A pencil source puts ~6*10^4
//   deposits a launch into its hottest cell, and float atomics on one
//   address serialise in L2.
//
// What the design does about it:
//   - Deposit cache.  Each block keeps kCacheSlots (cell, sum) pairs in
//     shared memory, direct-mapped by a hash of the cell.  A deposit
//     whose slot is empty or holds its cell adds there; any other adds
//     to device memory; at its end the block adds its cached sums to
//     device memory, so the hottest cell takes one device-memory add a
//     block rather than one a deposit.  (Warp-level aggregation alone
//     recovered a third as much.)
//   - Lanes ordered at launch.  Each block runs its lanes alive at
//     launch first, so in the tail rounds the dead ones fill whole
//     warps; a warp whose lanes are all dead draws the remaining
//     uniforms and leaves the loop.  Lanes that die during the launch
//     ride along masked, which costs their warp nothing.
//   - No local memory: the crossing axis is selected by comparison, not
//     by array index, so the small arrays stay in registers (indexing
//     them kept a 64-byte stack frame).  One division an axis
//     whichever way the lane moves (its numerator picked first),
//     sincosf for the azimuth, and the Fresnel arithmetic only where
//     the index changes.
//   - The C entry point zeroes the accumulated outputs itself
//     (cudaMemsetAsync on the stream), so the wrapper issues one call.
//   - Kept: one thread per lane, 256 threads a block, the state in
//     registers for all K segments.  The measurements that decided:
//     512- or 1024-thread blocks, 512/2048/4096 cache slots, the media
//     table or the labels in shared memory, the per-medium path in
//     registers or shared memory, and __launch_bounds__ minima of 6 or
//     8 blocks were each no faster, or faster mid-run and slower over a
//     whole run.
//
// Parity: the arithmetic of each lane follows repro_torch/core/photon.py
//   and repro_torch/detectors operation by operation.  Build with
//   --fmad=false and without fast math: every constant below is a float
//   literal, and logf/expf/sincosf/sqrtf and IEEE division give what
//   PyTorch's elementwise CUDA operators give, so the per-lane state
//   (and ppath, cap_det, cap_gate and the stats block) matches the
//   plain version bit for bit; which thread runs a lane changes
//   nothing.  Grid cells (fluence, exitance, TPSF, path sums, Jacobian)
//   are float32 sums in an order that changes from run to run: the
//   cache changes only that order.  No group writes a variable of the
//   lane state, so the state and the base outputs are the same with any
//   group on or off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDirEps = 1e-9f;
constexpr float kInf = 1e30f;
constexpr float kSegMin = 1e-6f;          // float32(1e-4 * 0.01)
constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kCLight = 299.792458f;    // mm/ns
constexpr float kU24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kZExitFace = 0.25f;

// Launch shape: one thread per lane, kThreads a block (the wrapper's
// launch_plan passes the same number and the block count).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Deposit cache: kCacheSlots (key, sum) pairs in each block's shared
// memory, direct-mapped by a multiplicative hash of the cell.
constexpr int kCacheLog2 = 10;
constexpr int kCacheSlots = 1 << kCacheLog2;
constexpr int kEmpty = -1;

#ifndef PS_GROUPS
#define PS_GROUPS 0
#endif
constexpr int kGroupDet = 1, kGroupRecord = 2, kGroupJac = 4,
              kGroupStats = 8;
constexpr bool kDet = (PS_GROUPS & kGroupDet) != 0;
constexpr bool kRecord = (PS_GROUPS & kGroupRecord) != 0;
constexpr bool kJac = (PS_GROUPS & kGroupJac) != 0;
constexpr bool kStats = (PS_GROUPS & kGroupStats) != 0;
static_assert(PS_GROUPS >= 0 && PS_GROUPS < 16, "PS_GROUPS is a 4-bit mask");
static_assert(!kRecord || kDet, "the RECORD group needs the DET group");

// Pointers and sizes of the optional groups; members of a group that is
// compiled out are null and never read.
struct Groups {
  const float* ppath_in;    // DET (n, n_media)
  const float* det_geom;    // DET (n_det, 3): x, y, radius^2
  const float* jac_w;       // JAC (n,)
  const int32_t* jac_col;   // JAC (n,)
  int* errors;              // JAC: bit 0 set by a jac_col outside
                            //   [0, jac_cols)
  float* ppath_out;         // DET (n, n_media)
  float* det_w;             // DET (n_det * ntg), zeroed
  float* det_ppath;         // DET (n_det, n_media), zeroed
  int32_t* cap_det;         // RECORD (n,)
  int32_t* cap_gate;        // RECORD (n,)
  float* jac;               // JAC (nvox * jac_cols), zeroed
  float* stats;             // STATS (n, 2)
  int n_det, n_media, jac_cols;
};

// Inputs, base outputs and scalars of one launch.
struct Args {
  const uint8_t* labels;
  const float* media;
  const float* pos_in;
  const float* dir_in;
  const int32_t* ivox_in;
  const float* w_in;
  const float* s_in;
  const float* t_in;
  const int64_t* rng_in;
  const uint8_t* alive_in;
  float* pos_out;
  float* dir_out;
  int32_t* ivox_out;
  float* w_out;
  float* s_out;
  float* t_out;
  int64_t* rng_out;
  uint8_t* alive_out;
  float* fluence;    // (nvox * ntg), zeroed
  float* exitance;   // (nx * ny), zeroed
  float* esc_out;
  float* timed_out;
  int n, nx, ny, nz, n_steps, ntg, general_exact;
  float unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p;
  Groups grp;
};

struct Rng {
  uint32_t x, y, z, w;
  __device__ __forceinline__ float uniform() {
    uint32_t t = x ^ (x << 11);
    t = t ^ (t >> 8);
    uint32_t nw = (w ^ (w >> 19)) ^ t;
    x = y;
    y = z;
    z = w;
    w = nw;
    return ((float)(nw >> 8) + 0.5f) * kU24;
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float signf(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// Adds v to cell `key` of the block's deposit cache: the first key to
// reach an empty slot claims it for the launch; a key whose slot another
// key holds adds straight to device memory at `miss`.
__device__ __forceinline__ void cache_add(int* s_key, float* s_val, int key,
                                          float v, float* miss) {
  const int slot = (int)(((unsigned)key * 2654435761u) >> (32 - kCacheLog2));
  int held = *(volatile int*)&s_key[slot];
  if (held == kEmpty) {
    held = atomicCAS(&s_key[slot], kEmpty, key);
    if (held == kEmpty) held = key;
  }
  if (held == key) {
    atomicAdd(&s_val[slot], v);
  } else {
    atomicAdd(miss, v);
  }
}

// K segments of one lane.  Fluence and exitance deposits go through the
// block's cache: fluence cell c under key c, exitance bin b under key
// nvox * ntg + b.
template <bool DO_REFLECT, bool TAYLOR>
__device__ __forceinline__ void run_lane(const Args& A, const int lane,
                                         int* s_key, float* s_val) {
  // --- LANE: the lane's state in, once a launch ---
  const Groups& grp = A.grp;
  const int nx = A.nx, ny = A.ny, nz = A.nz, ntg = A.ntg;
  const int n_flu = nx * ny * nz * ntg;
  float p[3], d[3];
  int iv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = A.pos_in[3 * lane + a];
    d[a] = A.dir_in[3 * lane + a];
    iv[a] = A.ivox_in[3 * lane + a];
  }
  float w = A.w_in[lane], s = A.s_in[lane], t = A.t_in[lane];
  Rng r;
  r.x = (uint32_t)A.rng_in[4 * lane + 0];
  r.y = (uint32_t)A.rng_in[4 * lane + 1];
  r.z = (uint32_t)A.rng_in[4 * lane + 2];
  r.w = (uint32_t)A.rng_in[4 * lane + 3];
  bool alive = A.alive_in[lane] != 0;
  float esc_acc = 0.f, timed_acc = 0.f;

  // the lane's per-medium path, carried in its row of ppath_out
  const int nm = grp.n_media;
  float* pp = nullptr;
  if (kDet) {
    pp = grp.ppath_out + (long long)lane * nm;
    for (int m = 0; m < nm; ++m)
      pp[m] = grp.ppath_in[(long long)lane * nm + m];
  }
  int cap_det = -1, cap_gate = 0;
  float jac_w = 0.f;
  int jac_col = 0;
  if (kJac) {
    jac_w = grp.jac_w[lane];
    jac_col = grp.jac_col[lane];
    // a column outside the grid adds nothing and flags the launch
    if ((unsigned)jac_col >= (unsigned)grp.jac_cols) {
      atomicOr(grp.errors, 1);
      jac_w = 0.f;
    }
  }
  float st_live = 0.f, st_dep = 0.f;

  for (int k = 0; k < A.n_steps; ++k) {
    // --- LOOP: the voxel and its medium ---
    // a dead lane's only effect is its 5 draws a segment: a warp whose
    // lanes are all dead draws the rest and leaves the loop
    if (__all_sync(__activemask(), !alive)) {
      for (int j = 5 * (A.n_steps - k); j > 0; --j) r.uniform();
      break;
    }
    const int cx = clampi(iv[0], 0, nx - 1);
    const int cy = clampi(iv[1], 0, ny - 1);
    const int cz = clampi(iv[2], 0, nz - 1);
    const int flat = (cx * ny + cy) * nz + cz;
    const int label = __ldg(A.labels + flat);
    const float mua = __ldg(A.media + 4 * label + 0) * A.unit;
    const float mus = __ldg(A.media + 4 * label + 1) * A.unit;
    const float g = __ldg(A.media + 4 * label + 2);
    const float n_cur = __ldg(A.media + 4 * label + 3);

    // --- UNIFORMS: always 5 a step, on every lane ---
    const float u_path = r.uniform();
    const float u_cos = r.uniform();
    const float u_phi = r.uniform();
    const float u_fres = r.uniform();
    const float u_roul = r.uniform();

    // --- HOP ---
    float s_new = (s <= 0.f) ? -logf(u_path) : s;
    float dist[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // one division whichever way the lane moves (its numerator
      // picked first), so a warp with both signs divides once an axis
      const float fv = (float)iv[a];
      const float num = d[a] > kDirEps ? (fv + 1.f) - p[a] : fv - p[a];
      const float q = num / d[a];
      dist[a] = fmaxf(fabsf(d[a]) > kDirEps ? q : kInf, 0.f);
    }
    const int axis = (dist[0] <= dist[1] && dist[0] <= dist[2])
                         ? 0 : (dist[1] <= dist[2] ? 1 : 2);
    const float d_wall = fminf(fminf(dist[0], dist[1]), dist[2]);
    float d_scat = s_new / fmaxf(mus, kDirEps);
    if (mus <= kDirEps) d_scat = kInf;
    const bool hits_wall = d_wall < d_scat;
    const float seg = fmaxf(hits_wall ? d_wall : d_scat, kSegMin);

    float np_[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) np_[a] = p[a] + d[a] * seg;
    s_new = hits_wall ? s_new - seg * mus : 0.f;
    const float t_new = t + seg * A.unit * n_cur / kCLight;

    // --- DROP ---
    const float tau = mua * seg;
    float dep, w_after;
    if (TAYLOR) {
      dep = w * fminf(tau, 1.f);
      w_after = w - dep;
    } else if (A.general_exact) {
      dep = w - w * expf(-tau);
      w_after = w - dep;
    } else {
      w_after = w * expf(-tau);
      dep = w - w_after;
    }

    // --- BOUNDARY: next voxel ---
    // (the crossing axis selects by comparison, not by index, so the
    // small arrays stay in registers)
    const float dir_axis = axis == 0 ? d[0] : (axis == 1 ? d[1] : d[2]);
    const int sgn = dir_axis > 0.f ? 1 : (dir_axis < 0.f ? -1 : 0);
    int nv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) nv[a] = iv[a] + (a == axis ? sgn : 0);
    const bool oob = nv[0] < 0 || nv[0] >= nx || nv[1] < 0 || nv[1] >= ny ||
                     nv[2] < 0 || nv[2] >= nz;
    int next_label = 0;
    if (!oob) next_label = __ldg(A.labels + (nv[0] * ny + nv[1]) * nz + nv[2]);
    const bool crossing = alive && hits_wall;
    const bool is_scatter = alive && !hits_wall;

    float nd[3] = {d[0], d[1], d[2]};
    bool reflects = false;
    if (is_scatter) {
      // --- SPIN: Henyey-Greenstein (MCML rotation formulas) ---
      const bool small_g = fabsf(g) < 1e-5f;
      const float gs = small_g ? 1.f : g;
      const float frac = (1.f - gs * gs) / (1.f - gs + 2.f * gs * u_cos);
      const float cost_hg = (1.f + gs * gs - frac * frac) / (2.f * gs);
      const float cost = clampf(small_g ? 2.f * u_cos - 1.f : cost_hg,
                                -1.f, 1.f);
      const float sint = sqrtf(fmaxf(1.f - cost * cost, 0.f));
      const float phi = kTwoPi * u_phi;
      float sinp, cosp;
      sincosf(phi, &sinp, &cosp);
      const float ux = d[0], uy = d[1], uz = d[2];
      float ox, oy, oz;
      if (fabsf(uz) > 0.99999f) {
        ox = sint * cosp;
        oy = sint * sinp;
        oz = cost * signf(uz);
      } else {
        const float tmp = sqrtf(fmaxf(1.f - uz * uz, 1e-12f));
        ox = sint * (ux * uz * cosp - uy * sinp) / tmp + ux * cost;
        oy = sint * (uy * uz * cosp + ux * sinp) / tmp + uy * cost;
        oz = -sint * cosp * tmp + uz * cost;
      }
      const float norm = fmaxf(sqrtf(ox * ox + oy * oy + oz * oz), 1e-12f);
      nd[0] = ox / norm;
      nd[1] = oy / norm;
      nd[2] = oz / norm;
    } else if (DO_REFLECT && crossing) {
      // --- Fresnel reflection / Snell refraction, only where the index
      // changes: without a mismatch the direction stays as it is ---
      const float n_next = __ldg(A.media + 4 * next_label + 3);
      if (fabsf(n_next - n_cur) > 1e-6f) {
        const float cos_i = clampf(fabsf(dir_axis), 0.f, 1.f);
        const float eta = n_cur / fmaxf(n_next, 1e-6f);
        const float sin2_t = eta * eta * fmaxf(1.f - cos_i * cos_i, 0.f);
        const bool tir = sin2_t >= 1.f;
        const float cos_t = sqrtf(fmaxf(1.f - sin2_t, 0.f));
        const float rs_num = n_cur * cos_i - n_next * cos_t;
        const float rs_den = n_cur * cos_i + n_next * cos_t;
        const float rp_num = n_cur * cos_t - n_next * cos_i;
        const float rp_den = n_cur * cos_t + n_next * cos_i;
        const float rs = rs_num / (fabsf(rs_den) < 1e-12f ? 1.f : rs_den);
        const float rp = rp_num / (fabsf(rp_den) < 1e-12f ? 1.f : rp_den);
        const float refl_r = clampf(tir ? 1.f : 0.5f * (rs * rs + rp * rp),
                                    0.f, 1.f);
        reflects = u_fres < refl_r;
        if (reflects) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            if (a == axis) nd[a] = d[a] * -1.f;
        } else {
          float tr[3];
          const float sgnf = (float)sgn;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float af = a == axis ? 1.f : 0.f;
            tr[a] = d[a] * (1.f - af) * eta + af * (sgnf * cos_t);
          }
          const float tnorm = fmaxf(
              sqrtf(tr[0] * tr[0] + tr[1] * tr[1] + tr[2] * tr[2]), 1e-12f);
#pragma unroll
          for (int a = 0; a < 3; ++a) nd[a] = tr[a] / tnorm;
        }
      }
    }

    const bool escapes = crossing && !reflects && (oob || next_label == 0);
    const bool advances = crossing && !reflects && !escapes;

    // --- ROULETTE, then the time gate, then escape zeroing ---
    bool alive_after = alive && !escapes;
    const bool low_w = alive_after && (w_after < A.w_threshold);
    const bool survives = u_roul < A.roulette_p;
    float w_final =
        low_w ? (survives ? w_after * A.roulette_m : 0.f) : w_after;
    alive_after = alive_after && !(low_w && !survives);
    const bool gate_kill = alive_after && (t_new > A.tmax);
    alive_after = alive_after && !gate_kill;
    const float timed_w = gate_kill ? w_final : 0.f;
    const float esc_w = escapes ? w_after : 0.f;
    if (escapes) w_final = 0.f;

    if (kStats) {
      st_live = st_live + (alive ? 1.f : 0.f);
      st_dep = st_dep + (alive ? dep : 0.f);
    }
    // --- DEPOSIT, detector capture, and the state update ---
    if (alive) {
      // deposition (zero deposits add nothing and are skipped); the gate
      // is computed where it is used, so the base variant does no work
      // of the groups
      if (dep != 0.f) {
        const int gate = clampi((int)floorf(t_new * A.gate_scale), 0, ntg - 1);
        const int cell = flat * ntg + gate;
        cache_add(s_key, s_val, cell, dep, A.fluence + cell);
      }
      const float seg_len = seg * A.unit;
      if (kDet) {
        // the segment's path joins the lane's medium sum before the
        // capture test, so a detected photon carries its last segment
        pp[label] = pp[label] + seg_len;
        if (esc_w > 0.f && np_[2] < kZExitFace) {
          int det = -1;  // the first disk that holds the exit point
          for (int dd = 0; dd < grp.n_det; ++dd) {
            const float dx = np_[0] - __ldg(grp.det_geom + 3 * dd + 0);
            const float dy = np_[1] - __ldg(grp.det_geom + 3 * dd + 1);
            if (dx * dx + dy * dy <= __ldg(grp.det_geom + 3 * dd + 2)) {
              det = dd;
              break;
            }
          }
          if (det >= 0) {
            const int gate =
                clampi((int)floorf(t_new * A.gate_scale), 0, ntg - 1);
            atomicAdd(grp.det_w + (long long)det * ntg + gate, esc_w);
            for (int m = 0; m < nm; ++m) {
              const float v = esc_w * pp[m];
              if (v != 0.f)
                atomicAdd(grp.det_ppath + (long long)det * nm + m, v);
            }
            if (kRecord) {
              cap_det = det;
              cap_gate = gate;
            }
          }
        }
      }
      if (kJac) {
        const float v = jac_w * seg_len;
        if (v != 0.f)
          atomicAdd(grp.jac + (long long)flat * grp.jac_cols + jac_col, v);
      }
      if (esc_w > 0.f && np_[2] < kZExitFace) {
        const int ex = clampi((int)floorf(np_[0]), 0, nx - 1);
        const int ey = clampi((int)floorf(np_[1]), 0, ny - 1);
        const int bin = ex * ny + ey;
        cache_add(s_key, s_val, n_flu + bin, esc_w, A.exitance + bin);
      }
      esc_acc = esc_acc + esc_w;
      timed_acc = timed_acc + timed_w;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p[a] = np_[a];
        d[a] = nd[a];
      }
      if (advances) {
#pragma unroll
        for (int a = 0; a < 3; ++a) iv[a] = nv[a];
      }
      w = w_final;
      s = s_new;
      t = t_new;
    }
    alive = alive_after;
  }

  // --- WRITE-BACK, once a launch ---
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    A.pos_out[3 * lane + a] = p[a];
    A.dir_out[3 * lane + a] = d[a];
    A.ivox_out[3 * lane + a] = iv[a];
  }
  A.w_out[lane] = w;
  A.s_out[lane] = s;
  A.t_out[lane] = t;
  A.rng_out[4 * lane + 0] = (int64_t)r.x;
  A.rng_out[4 * lane + 1] = (int64_t)r.y;
  A.rng_out[4 * lane + 2] = (int64_t)r.z;
  A.rng_out[4 * lane + 3] = (int64_t)r.w;
  A.alive_out[lane] = alive ? 1 : 0;
  A.esc_out[lane] = esc_acc;
  A.timed_out[lane] = timed_acc;
  if (kRecord) {
    grp.cap_det[lane] = cap_det;
    grp.cap_gate[lane] = cap_gate;
  }
  if (kStats) {
    grp.stats[2 * lane + 0] = st_live;
    grp.stats[2 * lane + 1] = st_dep;
  }
}

// One block: its lanes reordered so that those alive at launch come
// first (each keeps its own arithmetic; only the thread that runs it
// changes), K segments of each, then the block's deposit cache added to
// device memory.
template <bool DO_REFLECT, bool TAYLOR>
__global__ void __launch_bounds__(kThreads)
    photon_step_kernel(const __grid_constant__ Args A) {
  // --- BLOCK: the cache emptied, the lanes ordered ---
  __shared__ int s_key[kCacheSlots];
  __shared__ float s_val[kCacheSlots];
  __shared__ int s_order[kThreads];
  __shared__ int s_warp_live[kWarps];
  for (int i = threadIdx.x; i < kCacheSlots; i += kThreads) {
    s_key[i] = kEmpty;
    s_val[i] = 0.f;
  }
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
  const int first = blockIdx.x * kThreads;
  const bool live = first + tid < A.n && A.alive_in[first + tid] != 0;
  const unsigned live_bits = __ballot_sync(0xffffffffu, live);
  if (lid == 0) s_warp_live[wid] = __popc(live_bits);
  __syncthreads();
  int live_before = 0, n_live = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = s_warp_live[i];
    live_before += i < wid ? c : 0;
    n_live += c;
  }
  // a stable partition: live lanes in lane order, then the rest
  const int live_below = live_before + __popc(live_bits & ((1u << lid) - 1u));
  s_order[live ? live_below : n_live + tid - live_below] = tid;
  __syncthreads();
  const int lane = first + s_order[tid];
  if (lane < A.n) run_lane<DO_REFLECT, TAYLOR>(A, lane, s_key, s_val);
  // --- FLUSH: the block's cached sums into device memory ---
  __syncthreads();
  const int n_flu = A.nx * A.ny * A.nz * A.ntg;
  for (int i = tid; i < kCacheSlots; i += kThreads) {
    const int key = s_key[i];
    const float v = s_val[i];
    if (key != kEmpty && v != 0.f)
      atomicAdd(key < n_flu ? A.fluence + key : A.exitance + (key - n_flu), v);
  }
}

template <bool DO_REFLECT, bool TAYLOR>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  photon_step_kernel<DO_REFLECT, TAYLOR><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in:  labels, media, pos, dir, ivox, w, s_left, t, rng, alive (10),
//        then [ppath, det_geom] (DET), [jac_w, jac_col, errors] (JAC;
//        errors is one int32 the kernel ORs 1 into for a bad jac_col)
//   out: pos, dir, ivox, w, s_left, t, rng, alive, fluence, exitance,
//        escaped, timed (12), then [ppath, det_w, det_ppath] (DET),
//        [cap_det, cap_gate] (RECORD), [jac] (JAC), [stats] (STATS);
//        fluence, exitance, det_w, det_ppath and jac are zeroed here,
//        on the stream, before the launch
//   ints:   n, nx, ny, nz, n_steps, ntg, general_exact, do_reflect, taylor,
//           groups, n_det, n_media, jac_cols, threads, blocks
//   floats: unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p
// Returns the cudaError_t of the memsets and the launch (0 on success),
// or cudaErrorInvalidValue when ``groups`` is not the set this library
// was built for, ``threads`` is not its block size or ``blocks`` do not
// cover the lanes.
extern "C" int photon_step_launch(const void* const* in, void* const* out,
                                  const int* ints, const float* floats,
                                  void* stream) {
  const int n = ints[0], groups = ints[9], n_det = ints[10],
            n_media = ints[11], jac_cols = ints[12], threads = ints[13],
            blocks = ints[14];
  if (groups != PS_GROUPS || threads != kThreads ||
      (long long)blocks * kThreads < n || (n > 0 && blocks <= 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t nvox = (size_t)ints[1] * ints[2] * ints[3];
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
  a.pos_out = (float*)out[0];
  a.dir_out = (float*)out[1];
  a.ivox_out = (int32_t*)out[2];
  a.w_out = (float*)out[3];
  a.s_out = (float*)out[4];
  a.t_out = (float*)out[5];
  a.rng_out = (int64_t*)out[6];
  a.alive_out = (uint8_t*)out[7];
  a.fluence = (float*)out[8];
  a.exitance = (float*)out[9];
  a.esc_out = (float*)out[10];
  a.timed_out = (float*)out[11];
  a.n = n;
  a.nx = ints[1];
  a.ny = ints[2];
  a.nz = ints[3];
  a.n_steps = ints[4];
  a.ntg = ints[5];
  a.general_exact = ints[6];
  a.unit = floats[0];
  a.gate_scale = floats[1];
  a.tmax = floats[2];
  a.w_threshold = floats[3];
  a.roulette_m = floats[4];
  a.roulette_p = floats[5];
  // the optional inputs and outputs follow the base ones, in the order
  // of the output contract (kernels/photon_step/spec.py)
  Groups& grp = a.grp;
  int i_in = 10, i_out = 12;
  if (kDet) {
    grp.ppath_in = (const float*)in[i_in++];
    grp.det_geom = (const float*)in[i_in++];
    grp.ppath_out = (float*)out[i_out++];
    grp.det_w = (float*)out[i_out++];
    grp.det_ppath = (float*)out[i_out++];
  }
  if (kJac) {
    grp.jac_w = (const float*)in[i_in++];
    grp.jac_col = (const int32_t*)in[i_in++];
    grp.errors = (int*)in[i_in++];
  }
  if (kRecord) {
    grp.cap_det = (int32_t*)out[i_out++];
    grp.cap_gate = (int32_t*)out[i_out++];
  }
  if (kJac) grp.jac = (float*)out[i_out++];
  if (kStats) grp.stats = (float*)out[i_out++];
  grp.n_det = n_det;
  grp.n_media = n_media;
  grp.jac_cols = jac_cols;

  const struct { void* p; size_t bytes; } zero[] = {
      {a.fluence, 4 * nvox * a.ntg},
      {a.exitance, 4 * (size_t)a.nx * a.ny},
      {grp.det_w, 4 * (size_t)n_det * a.ntg},
      {grp.det_ppath, 4 * (size_t)n_det * n_media},
      {grp.jac, 4 * nvox * jac_cols}};
  for (const auto& z : zero) {
    if (z.p == nullptr || z.bytes == 0) continue;
    const cudaError_t err = cudaMemsetAsync(z.p, 0, z.bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n <= 0) return 0;
  const bool do_reflect = ints[7] != 0, taylor = ints[8] != 0;
  cudaError_t err;
  if (do_reflect) {
    err = taylor ? launch<true, true>(a, blocks, s)
                 : launch<true, false>(a, blocks, s);
  } else {
    err = taylor ? launch<false, true>(a, blocks, s)
                 : launch<false, false>(a, blocks, s);
  }
  return (int)err;
}

extern "C" int photon_step_groups() { return PS_GROUPS; }

// The kernel's compile-time launch constants, which the wrapper checks
// against its own: threads a block, deposit-cache slots.
extern "C" int photon_step_threads() { return kThreads; }
extern "C" int photon_step_cache_slots() { return kCacheSlots; }

extern "C" const char* photon_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
