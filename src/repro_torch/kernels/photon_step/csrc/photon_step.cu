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
//     (cudaMemsetAsync on the stream), so the wrapper issues one call;
//     with add_into the fixed-point grids are the caller's run totals,
//     which the launch adds into (the simulator issues no grid sums).
//   - The round's tail in the epilogue.  Given the round loop's tail
//     buffers (RoundTail in photon_step.py), the launch does what the
//     loop did after it with ~18 PyTorch launches a round: each block
//     sums its lanes' escaped and timed-out weight in int64 fixed point
//     and adds the sums into the run's per-scenario totals, and the last
//     block to finish counts the round and sets the work flags the host
//     reads (round_tail below).  The per-lane escaped and timed-out
//     outputs are then not written.
//   - The records' append in the epilogue.  Given also the round loop's
//     record buffers (RoundRecords in photon_step.py; the RECORD
//     group), the launch appends each captured lane's row [id_lo, id_hi,
//     det, gate] to its scenario's record buffer, where the loop ran ~24
//     PyTorch launches over every lane a round for ~13 captures.  Each
//     block that captured stages its captures' rows in lane order and
//     publishes their count; the last block scans the counts of each
//     scenario in block order and moves the staged rows into the
//     buffer, so the rows land in the slots of a prefix sum in lane
//     order, the same bits as the plain append, overflow included
//     (append_records below).  Slots picked in arrival order by atomics
//     would change the buffer's order and, when it fills, which records
//     are kept.  Such a launch runs photon_step_append_kernel, the same
//     block code with the append compiled in, so the launches without
//     records (the replay's) run the code they ran before it came.
//   - Kept: one thread per lane, 256 threads a block, the state in
//     registers for all K segments.  The measurements that decided:
//     512- or 1024-thread blocks, 512/2048/4096 cache slots, the media
//     table or the labels in shared memory, the per-medium path in
//     registers or shared memory, and __launch_bounds__ minima of 6 or
//     8 blocks were each no faster, or faster mid-run and slower over a
//     whole run.
//
// Order-independent sums.  Fluence, exitance, the TPSF (det_w), the
//   detector path sums (det_ppath) and the replay Jacobian (jac) are
//   64-bit fixed point: each deposit is rounded once to a whole number
//   of 2^-s units (__float2ll_rn of v * 2^s, round to nearest even) and
//   added with integer atomics, in the shared-memory cache and in device
//   memory alike.  Integer addition is associative, so a grid is the
//   same whatever order lanes, warps and blocks add in and whichever key
//   claims a cache slot; the plain version rounds each deposit the same
//   way, so the kernel's grids are bit-equal to it.  Per output
//   (kernels/photon_step/spec.py FIXED_SHIFT):
//     fluence, exitance, det_w  s = 36: a unit of 1.46e-11 weight, at
//                               most 2^27 = 1.34e8 weight in one cell
//     det_ppath                 s = 28: a unit of 3.73e-9 weight * mm, at
//                               most 2^35 = 3.44e10 weight * mm in one sum
//     jac                       s = 36: a unit of 1.46e-11 weight * mm, at
//                               most 2^27 = 1.34e8 weight * mm in one cell
//   A deposit of 2^44 units or more (256 weight, or weight * mm for the
//   Jacobian; 65536 weight * mm for the path sums) or a non-finite one
//   adds nothing and sets bit 2 of the error word, which
//   photon_step.check_errors() turns into an exception; so does a cached
//   or detector sum that passes 2^63 - 1 as the block adds it.  Deposits
//   added straight to device memory do not wait for the old value: a
//   cell they take past 2^63 - 1 shows a negative value, which the
//   simulator and the replay check once at the end of a run (waiting for
//   it would hold the lane for a round trip to L2).
//
// Replay launches.  The replay (repro_torch.replay) runs the DET+RECORD
//   and the JAC variants on a few ten thousand lanes whose trajectories
//   are long: a pass is a few launches of up to 4095 segments, not one
//   launch a round.  Such a launch is bound by its longest lane, a chain
//   of dependent segments on one warp, while the rest of the card idles
//   in its tail.  So a replay launch adds into the caller's totals
//   (add_into) and zeroes nothing: the caller keeps one int64 Jacobian
//   on the device for the whole replay, and scratch fluence and
//   exitance grids it zeroes once.  The Jacobian's deposits go straight
//   to device memory with integer atomics that do not wait (through the
//   block's cache they took 5% longer: neighbouring lanes mostly carry
//   other Jacobian columns).
//
// Scenarios.  One launch may advance S scenarios of n lanes each (the
//   batched executor of repro_torch.scenarios): blockIdx.y is the
//   scenario, so a block never spans two, and its deposit cache stays
//   keyed by cell alone.  Each scenario has its own media table,
//   detector geometry and output grids, at a fixed stride; labels are
//   shared (stride 0) or stacked (stride nvox).
//
// Parity: the arithmetic of each lane follows repro_torch/core/photon.py
//   and repro_torch/detectors operation by operation.  Build with
//   --fmad=false and without fast math: every constant below is a float
//   literal, and logf/expf/sincosf/sqrtf and IEEE division give what
//   PyTorch's elementwise CUDA operators give, so the per-lane state
//   (and ppath, cap_det, cap_gate and the stats block) matches the
//   plain version bit for bit; which thread runs a lane changes
//   nothing.  No group writes a variable of the lane state, so the state
//   and the base outputs are the same with any group on or off.

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
static_assert(kWarps >= 3, "the round's tail takes a thread of three warps");
// Deposit cache: kCacheSlots (key, sum) pairs in each block's shared
// memory, direct-mapped by a multiplicative hash of the cell.
constexpr int kCacheLog2 = 10;
constexpr int kCacheSlots = 1 << kCacheLog2;
constexpr int kEmpty = -1;

// Fixed point of the order-independent grids: 2^36 units of weight
// (fluence, exitance, det_w), 2^28 units of weight * mm (det_ppath) and
// 2^36 units of weight * mm (jac).
constexpr float kWeightScale = 68719476736.0f;  // 2^36
constexpr float kPathScale = 268435456.0f;      // 2^28
constexpr float kJacScale = 68719476736.0f;     // 2^36, weight * mm
// Fixed point of the run's escaped and timed-out totals: 2^24 units of
// weight (spec.TOTAL_SHIFT).
constexpr float kTotalScale = 16777216.0f;      // 2^24
// Pointers of the round's tail (RoundTail in photon_step.py).
constexpr int kTailWords = 7;
// Words of the round's records (RoundRecords in photon_step.py): six
// pointers and the capacity.
constexpr int kRecordWords = 7;
// One deposit holds fewer than 2^44 units (256 weight, 65536 weight *
// mm): a block's cached sum of at most 256 lanes x 4095 segments of
// them stays below 2^64, so its sign shows a pass of 2^63.
constexpr float kDepositLimit = 17592186044416.0f;  // 2^44
// Bits of the error word: a jac_col outside [0, jac_cols), and a
// fixed-point deposit or sum beyond 2^63 - 1 units.
constexpr int kErrJacCol = 1, kErrOverflow = 2;

typedef unsigned long long u64;

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
  float* ppath_out;         // DET (n, n_media)
  u64* det_w;               // DET (n_det * ntg), 2^-36 weight units
  u64* det_ppath;           // DET (n_det, n_media), 2^-28 weight * mm
  int32_t* cap_det;         // RECORD (n,)
  int32_t* cap_gate;        // RECORD (n,)
  u64* jac;                 // JAC (nvox * jac_cols), 2^-36 weight * mm
  float* stats;             // STATS (n, 2)
  int n_det, n_media, jac_cols;
};

// The round's tail (RoundTail in photon_step.py), all null when the
// caller gives none: the run's per-scenario buffers, in place.
struct Tail {
  u64* escaped;                // (S) 2^-24 weight units, added into
  u64* timed;                  // (S) 2^-24 weight units, added into
  long long* rounds;           // (S) rounds in which the scenario had work
  uint8_t* work;               // (S) work left after this round
  uint8_t* more;               // () any scenario's work: what the host reads
  const long long* remaining;  // (S) budgets after this round's relaunch
  unsigned* flags;             // (S + 1) any lane alive, then the ticket;
                               // zero between launches
};

// The round's records (RoundRecords in photon_step.py), all null when the
// caller gives none: the run's per-scenario record buffers, in place.
struct Records {
  long long* rec;              // (S, capacity + 1, 4) rows [id_lo, id_hi,
                               // det, gate]; the last row is not written
  long long* kept;             // (S) rows kept
  long long* overflow;         // (S) captures dropped, the buffer full
  const long long* lane_ids;   // (S * n, 2) each lane's photon id words
  unsigned* counts;            // (S * blocks) each block's captures, zero
                               // between launches
  long long* rows;             // (S * blocks * kThreads, 4) each block's
                               // staged rows, in lane order
  long long capacity;
};

// Inputs, base outputs and scalars of one launch.
struct Args {
  const uint8_t* labels;    // (nvox), or (S, nvox) with labels_stride nvox
  const float* media;       // (S, n_media, 4)
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
  u64* fluence;      // (S, nvox * ntg), 2^-36 weight units
  u64* exitance;     // (S, nx * ny), 2^-36 weight units
  float* esc_out;    // null with the tail
  float* timed_out;  // null with the tail
  int* errors;       // kErrJacCol | kErrOverflow, ORed in
  long long labels_stride;
  int n, nx, ny, nz, n_steps, ntg, general_exact;
  float unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p;
  Groups grp;
  Tail tail;
  Records rec;
};

// What a lane leaves for the round's tail: its weight escaped and timed
// out in the launch, whether it is alive at the end, and its capture
// (RECORD; det -1: none).
struct LaneEnd {
  float esc, timed;
  bool alive;
  int det, gate;
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

// v in fixed point (v * scale rounded to nearest even), or 0 with the
// overflow bit set for a deposit of 2^44 units or more, or not finite.
__device__ __forceinline__ u64 to_fixed(float v, float scale, int* errors) {
  const float x = v * scale;
  if (!(x < kDepositLimit)) {
    atomicOr(errors, kErrOverflow);
    return 0ull;
  }
  return (u64)__float2ll_rn(x);
}

// Adds u to *p with an integer atomic and checks the sum: a u or a sum
// past 2^63 - 1 sets the overflow bit and adds nothing more.  Used where
// few adds go (the cache flush, detector sums), as it waits for the old
// value.
__device__ __forceinline__ void add_fixed(u64* p, u64 u, int* errors) {
  if ((long long)u < 0) {
    atomicOr(errors, kErrOverflow);
    return;
  }
  const u64 old = atomicAdd(p, u);
  if ((long long)(old + u) < 0) atomicOr(errors, kErrOverflow);
}

// Adds u to cell `key` of the block's deposit cache: the first key to
// reach an empty slot claims it for the launch; a key whose slot another
// key holds adds straight to device memory at `miss`.  Neither add waits
// for its old value: a cached sum is checked when the block flushes it,
// and a grid that took a direct add past 2^63 - 1 shows a negative cell
// where the simulator reads its totals.
__device__ __forceinline__ void cache_add(int* s_key, u64* s_val, int key,
                                          u64 u, u64* miss) {
  const int slot = (int)(((unsigned)key * 2654435761u) >> (32 - kCacheLog2));
  int held = *(volatile int*)&s_key[slot];
  if (held == kEmpty) {
    held = atomicCAS(&s_key[slot], kEmpty, key);
    if (held == kEmpty) held = key;
  }
  atomicAdd(held == key ? &s_val[slot] : miss, u);
}

// K segments of one lane of scenario `sc`.  Fluence and exitance
// deposits go through the block's cache: fluence cell c under key c,
// exitance bin b under key nvox * ntg + b, both of the block's scenario.
template <bool DO_REFLECT, bool TAYLOR>
__device__ __forceinline__ LaneEnd run_lane(const Args& A, const int sc,
                                         const long long lane, int* s_key,
                                         u64* s_val) {
  // --- LANE: the lane's state in, once a launch ---
  const Groups& grp = A.grp;
  const int nx = A.nx, ny = A.ny, nz = A.nz, ntg = A.ntg;
  const int nvox = nx * ny * nz, n_flu = nvox * ntg;
  const int nm = grp.n_media;
  // the scenario's labels, media, detector geometry and grids
  const uint8_t* labels = A.labels + sc * A.labels_stride;
  const float* media = A.media + (long long)sc * nm * 4;
  u64* fluence = A.fluence + (long long)sc * n_flu;
  u64* exitance = A.exitance + (long long)sc * nx * ny;
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
  float* pp = nullptr;
  const float* det_geom = nullptr;
  u64* det_w = nullptr;
  u64* det_ppath = nullptr;
  if (kDet) {
    pp = grp.ppath_out + lane * nm;
    for (int m = 0; m < nm; ++m) pp[m] = grp.ppath_in[lane * nm + m];
    det_geom = grp.det_geom + (long long)sc * grp.n_det * 3;
    det_w = grp.det_w + (long long)sc * grp.n_det * ntg;
    det_ppath = grp.det_ppath + (long long)sc * grp.n_det * nm;
  }
  u64* jac = nullptr;
  int cap_det = -1, cap_gate = 0;
  float jac_w = 0.f;
  int jac_col = 0;
  if (kJac) {
    jac_w = grp.jac_w[lane];
    jac_col = grp.jac_col[lane];
    // a column outside the grid adds nothing and flags the launch
    if ((unsigned)jac_col >= (unsigned)grp.jac_cols) {
      atomicOr(A.errors, kErrJacCol);
      jac_w = 0.f;
    }
    jac = grp.jac + (long long)sc * nvox * grp.jac_cols;
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
    const int label = __ldg(labels + flat);
    const float mua = __ldg(media + 4 * label + 0) * A.unit;
    const float mus = __ldg(media + 4 * label + 1) * A.unit;
    const float g = __ldg(media + 4 * label + 2);
    const float n_cur = __ldg(media + 4 * label + 3);

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
    if (!oob) next_label = __ldg(labels + (nv[0] * ny + nv[1]) * nz + nv[2]);
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
      const float n_next = __ldg(media + 4 * next_label + 3);
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
        cache_add(s_key, s_val, cell, to_fixed(dep, kWeightScale, A.errors),
                  fluence + cell);
      }
      const float seg_len = seg * A.unit;
      if (kDet) {
        // the segment's path joins the lane's medium sum before the
        // capture test, so a detected photon carries its last segment
        pp[label] = pp[label] + seg_len;
        if (esc_w > 0.f && np_[2] < kZExitFace) {
          int det = -1;  // the first disk that holds the exit point
          for (int dd = 0; dd < grp.n_det; ++dd) {
            const float dx = np_[0] - __ldg(det_geom + 3 * dd + 0);
            const float dy = np_[1] - __ldg(det_geom + 3 * dd + 1);
            if (dx * dx + dy * dy <= __ldg(det_geom + 3 * dd + 2)) {
              det = dd;
              break;
            }
          }
          if (det >= 0) {
            const int gate =
                clampi((int)floorf(t_new * A.gate_scale), 0, ntg - 1);
            add_fixed(det_w + det * ntg + gate,
                      to_fixed(esc_w, kWeightScale, A.errors), A.errors);
            for (int m = 0; m < nm; ++m) {
              const float v = esc_w * pp[m];
              if (v != 0.f)
                add_fixed(det_ppath + det * nm + m,
                          to_fixed(v, kPathScale, A.errors), A.errors);
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
        if (v != 0.f) {
          const u64 u = to_fixed(v, kJacScale, A.errors);
          atomicAdd(jac + (long long)flat * grp.jac_cols + jac_col, u);
        }
      }
      if (esc_w > 0.f && np_[2] < kZExitFace) {
        const int ex = clampi((int)floorf(np_[0]), 0, nx - 1);
        const int ey = clampi((int)floorf(np_[1]), 0, ny - 1);
        const int bin = ex * ny + ey;
        cache_add(s_key, s_val, n_flu + bin,
                  to_fixed(esc_w, kWeightScale, A.errors), exitance + bin);
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
  if (A.tail.escaped == nullptr) {
    A.esc_out[lane] = esc_acc;
    A.timed_out[lane] = timed_acc;
  }
  if (kRecord) {
    grp.cap_det[lane] = cap_det;
    grp.cap_gate[lane] = cap_gate;
  }
  if (kStats) {
    grp.stats[2 * lane + 0] = st_live;
    grp.stats[2 * lane + 1] = st_dep;
  }
  return {esc_acc, timed_acc, alive, cap_det, cap_gate};
}

// --- RECORDS: the round's captures appended ---
// Each block stages its captures' rows [id_lo, id_hi, det, gate] in lane
// order (stage_row), and the last block to finish moves them into the
// record buffers (append_records).  For each scenario, in tiles of
// kThreads * kScanRun blocks, each thread loads the capture counts of
// kScanRun consecutive blocks, a block-wide scan of their sums gives the
// first slot of its blocks (the scenario's kept count, the captures of
// the tiles and threads before), and the thread copies its blocks'
// staged rows there, drops a row whose slot is at the capacity or past
// it, and zeroes the counts it read.  Thread 0 then clamps the kept count
// at the capacity and adds the rest to the overflow count: the slots,
// counts and overflow of simulator._append_records.  A capture is rare
// (~13 in 262144 lanes a round in head5.td), so the last block's work is
// a chain of two loads (the counts, then the staged rows) while the rest
// of the card waits, and its loops stay small: their instructions are
// fetched once a launch.  Values that other blocks wrote in this launch
// are read past L1 (__ldcg).
constexpr int kScanRun = 4;

// A captured lane's row, at its rank among its block's captures in lane
// order (the bits below its own in the block's complete mask `s_cap`),
// fenced before the block's count is published.
__device__ __forceinline__ void stage_row(const Args& A, const int sc,
                                          const int pos, const LaneEnd& end,
                                          const unsigned* s_cap) {
  int rank = __popc(s_cap[pos >> 5] & ((1u << (pos & 31)) - 1u));
  for (int w = 0; w < (pos >> 5); ++w) rank += __popc(s_cap[w]);
  const long long block = (long long)sc * gridDim.x + blockIdx.x;
  const long long lane =
      (long long)sc * A.n + (long long)blockIdx.x * kThreads + pos;
  longlong2* row = (longlong2*)(A.rec.rows + (block * kThreads + rank) * 4);
  row[0] = ((const longlong2*)A.rec.lane_ids)[lane];
  row[1] = make_longlong2(end.det, end.gate);
  __threadfence();  // the row before the block's count
}

// Out of line: inlined into the appending kernel it cost that launch ~4 µs
// more (chip_smoke.py's records phase), the compiler then allocating the
// step's registers otherwise.
__device__ __noinline__ void append_records(const Args& A, u64* s_scan) {
  const Records& R = A.rec;
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
  const int blocks = gridDim.x, scenarios = gridDim.y;
  for (int s = 0; s < scenarios; ++s) {
    const long long first = (long long)s * blocks;  // the scenario's blocks
    long long kept = R.kept[s];  // the running count, unclamped
    const long long overflow = R.overflow[s];
    for (int tile = 0; tile < blocks; tile += kThreads * kScanRun) {
      const int b0 = tile + tid * kScanRun;
      u64 packed = 0ull;  // the counts, 16 bits each (at most kThreads)
      unsigned mine = 0u;
#pragma unroll
      for (int j = 0; j < kScanRun; ++j) {
        const unsigned c =
            b0 + j < blocks ? __ldcg(R.counts + first + b0 + j) : 0u;
        packed |= (u64)c << (16 * j);
        mine += c;
      }
      unsigned incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lid >= d) incl += v;
      }
      if (lid == 31) s_scan[wid] = incl;
      __syncthreads();
      u64 before = 0ull, total = 0ull;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        before += i < wid ? s_scan[i] : 0ull;
        total += s_scan[i];
      }
      long long slot = kept + (long long)(before + incl - mine);
      kept += (long long)total;
#pragma unroll 1
      for (int j = 0; j < kScanRun; ++j) {
        const int c = (int)(packed >> (16 * j) & 0xffffull);
        if (c == 0) continue;
        const long long b = first + b0 + j;
        R.counts[b] = 0u;
        const longlong2* from = (const longlong2*)(R.rows + b * kThreads * 4);
#pragma unroll 1
        for (int i = 0; i < c; ++i, ++slot) {
          if (slot >= R.capacity) continue;
          longlong2* row =
              (longlong2*)(R.rec + (s * (R.capacity + 1) + slot) * 4);
          row[0] = __ldcg(from + 2 * i);
          row[1] = __ldcg(from + 2 * i + 1);
        }
      }
      __syncthreads();  // every thread has read s_scan
    }
    if (tid == 0) {
      const long long kept_now = kept < R.capacity ? kept : R.capacity;
      R.overflow[s] = overflow + (kept - kept_now);
      R.kept[s] = kept_now;
    }
  }
}

// --- TAIL: the round's totals, round count and work flags ---
// Each lane's escaped and timed-out weight is rounded once to 2^-24
// units (to_fixed, as the plain version's to_fixed rounds it), summed
// over the block in int64 (warp shuffles, then shared memory) and added
// into its scenario's totals with one checked integer atomic a block and
// total, so the totals are the same in any order.  Whether any lane of
// the block is alive is ORed into the scenario's flag word.  Three
// threads of three warps issue these at once, so that the block's end
// waits for one chain of atomics, not for three (the totals' adds are
// not fenced: no block reads them).  The last block to finish (a ticket
// taken after a fence: the CUDA samples' threadFenceReduction) then,
// for each scenario, counts the round where
// the scenario had work before it, sets its work from its flag and its
// remaining budget (a static-mode lane below its quota is budget left:
// both regenerations subtract every relaunch from it), sets `more` from
// them all, and clears the flags and the ticket for the next launch.
// Given the records, each captured lane stages its row (stage_row; the
// block's capture mask `s_cap` is complete, the lanes having set their
// bits before the flush's barrier), thread 0 publishes the block's count
// of captures before its fence and ticket, and the last block appends
// (append_records).
template <bool APPEND>
__device__ __forceinline__ void round_tail(const Args& A, const int sc,
                                           const LaneEnd& end, const int pos,
                                           u64* s_sum, int* s_last,
                                           const unsigned* s_cap) {
  const Tail& T = A.tail;
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
  const int scenarios = gridDim.y;
  if (APPEND && end.det >= 0) stage_row(A, sc, pos, end, s_cap);
  u64 e = to_fixed(end.esc, kTotalScale, A.errors);
  u64 t = to_fixed(end.timed, kTotalScale, A.errors);
#pragma unroll
  for (int dl = 16; dl > 0; dl >>= 1) {
    e += __shfl_down_sync(0xffffffffu, e, dl);
    t += __shfl_down_sync(0xffffffffu, t, dl);
  }
  if (lid == 0) {
    s_sum[wid] = e;
    s_sum[kWarps + wid] = t;
  }
  const int alive = __syncthreads_or(end.alive);
  if (tid == 0) {
    if (alive) atomicOr(T.flags + sc, 1u);
    if (APPEND) {
      unsigned count = 0u;
      for (int w = 0; w < kWarps; ++w) count += __popc(s_cap[w]);
      if (count != 0u)
        A.rec.counts[(long long)sc * gridDim.x + blockIdx.x] = count;
    }
    __threadfence();
    const unsigned blocks = gridDim.x * gridDim.y;
    s_last[0] = atomicAdd(T.flags + scenarios, 1u) == blocks - 1u;
  } else if (tid == 32 || tid == 64) {
    // warp 1 adds the escaped total, warp 2 the timed-out one
    const int first = tid == 32 ? 0 : kWarps;
    u64 sum = 0ull;
    for (int k = 0; k < kWarps; ++k) sum += s_sum[first + k];
    if (sum != 0ull)
      add_fixed((tid == 32 ? T.escaped : T.timed) + sc, sum, A.errors);
  }
  __syncthreads();
  if (!s_last[0]) return;
  bool any = false;
  for (int s = tid; s < scenarios; s += kThreads) {
    const bool alive_s = atomicExch(T.flags + s, 0u) != 0u;
    if (T.work[s]) T.rounds[s] += 1;
    const bool w = alive_s || T.remaining[s] > 0;
    T.work[s] = w ? 1 : 0;
    any = any || w;
  }
  any = __syncthreads_or(any);
  if (tid == 0) {
    *T.more = any ? 1 : 0;
    T.flags[scenarios] = 0u;
  }
  if (APPEND) append_records(A, s_sum);
}

// One block, of one scenario (blockIdx.y): its lanes reordered so that
// those alive at launch come first (each keeps its own arithmetic; only
// the thread that runs it changes), K segments of each, then the block's
// deposit cache added to the scenario's grids in device memory, then,
// given the tail, the block's share of the round's tail, and with APPEND
// (the launch was given the round's records) its share of their append.
template <bool DO_REFLECT, bool TAYLOR, bool APPEND>
__device__ __forceinline__ void step_block(const Args& A) {
  // --- BLOCK: the cache emptied, the lanes ordered ---
  __shared__ int s_key[kCacheSlots];
  __shared__ u64 s_val[kCacheSlots];
  __shared__ int s_order[kThreads];
  __shared__ int s_warp_live[kWarps];
  __shared__ u64 s_tail[2 * kWarps];
  __shared__ int s_last[1];
  __shared__ unsigned s_cap[kWarps];
  for (int i = threadIdx.x; i < kCacheSlots; i += kThreads) {
    s_key[i] = kEmpty;
    s_val[i] = 0ull;
  }
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
  if (APPEND && tid < kWarps) s_cap[tid] = 0u;
  const int sc = blockIdx.y;
  const long long base = (long long)sc * A.n;  // the scenario's first lane
  const int first = blockIdx.x * kThreads;     // within the scenario
  const bool live = first + tid < A.n && A.alive_in[base + first + tid] != 0;
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
  const int local = first + s_order[tid];
  LaneEnd end = {0.f, 0.f, false, -1, 0};
  if (local < A.n)
    end = run_lane<DO_REFLECT, TAYLOR>(A, sc, base + local, s_key, s_val);
  if (APPEND && end.det >= 0)
    atomicOr(s_cap + (s_order[tid] >> 5), 1u << (s_order[tid] & 31));
  // --- FLUSH: the block's cached sums into device memory ---
  __syncthreads();
  const int n_flu = A.nx * A.ny * A.nz * A.ntg;
  u64* fluence = A.fluence + (long long)sc * n_flu;
  u64* exitance = A.exitance + (long long)sc * A.nx * A.ny;
  for (int i = tid; i < kCacheSlots; i += kThreads) {
    const int key = s_key[i];
    const u64 u = s_val[i];
    if (key != kEmpty && u != 0ull)
      add_fixed(key < n_flu ? fluence + key : exitance + (key - n_flu), u,
                A.errors);
  }
  if (A.tail.escaped != nullptr)
    round_tail<APPEND>(A, sc, end, s_order[tid], s_tail, s_last, s_cap);
}

template <bool DO_REFLECT, bool TAYLOR>
__global__ void __launch_bounds__(kThreads)
    photon_step_kernel(const __grid_constant__ Args A) {
  step_block<DO_REFLECT, TAYLOR, false>(A);
}

#if PS_GROUPS & 2  // kGroupRecord
// The launch given the round's records: a kernel of its own, so that the
// launches without them (the replay's, parity tests) run the code they
// ran before the append came.
template <bool DO_REFLECT, bool TAYLOR>
__global__ void __launch_bounds__(kThreads)
    photon_step_append_kernel(const __grid_constant__ Args A) {
  step_block<DO_REFLECT, TAYLOR, true>(A);
}
#endif

template <bool DO_REFLECT, bool TAYLOR>
cudaError_t launch(const Args& a, int blocks, int scenarios,
                   cudaStream_t stream) {
  const dim3 grid(blocks, scenarios);
#if PS_GROUPS & 2  // kGroupRecord
  if (a.rec.rec != nullptr) {
    photon_step_append_kernel<DO_REFLECT, TAYLOR>
        <<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
#endif
  photon_step_kernel<DO_REFLECT, TAYLOR><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in:  labels, media, pos, dir, ivox, w, s_left, t, rng, alive, errors
//        (11), then [ppath, det_geom] (DET), [jac_w, jac_col] (JAC);
//        errors is one int32 the kernel ORs its error bits into
//   out: pos, dir, ivox, w, s_left, t, rng, alive, fluence, exitance,
//        escaped, timed (12), then [ppath, det_w, det_ppath] (DET),
//        [cap_det, cap_gate] (RECORD), [jac] (JAC), [stats] (STATS);
//        fluence, exitance, det_w, det_ppath and jac are int64 fixed
//        point, zeroed here on the stream before the launch unless
//        add_into is set, when the launch adds into them
//   ints:   n, nx, ny, nz, n_steps, ntg, general_exact, do_reflect, taylor,
//           groups, n_det, n_media, jac_cols, scenarios, labels_stride,
//           add_into, threads, blocks
//   floats: unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p
// Returns the cudaError_t of the memsets and the launch (0 on success),
// or cudaErrorInvalidValue when ``groups`` is not the set this library
// was built for, ``threads`` is not its block size, ``blocks`` do not
// cover the lanes, ``scenarios`` is outside [1, 65535] or a tail comes
// with no lane, or records come with no tail or to a library without
// RECORD.  n is the lane count of one scenario and blocks the blocks of
// one scenario; lane arrays hold scenarios * n lanes, scenario-major.
// ``tail`` is null, or the round's tail, kTailWords pointers: escaped,
// timed_out, rounds, work, more, remaining, flags (photon_step.py
// RoundTail, in that order).  Given one, the launch updates it
// (round_tail) and writes no per-lane escaped or timed weight: those out
// slots may be null.
// ``records`` is null, or the round's records, kRecordWords words: rec,
// kept, overflow, lane_ids, counts, rows, capacity (the pointers of
// photon_step.py RoundRecords, in that order, then rec's rows less the
// write-off row).  Given them (and a tail), the launch appends its
// captures (append_records); cap_det and cap_gate are written as
// without them.
// The out state arrays (and ppath) may be the in ones, as the round
// loop passes them when it replays a captured round: each lane is read
// by the thread that runs it before that thread writes it, and a block
// reads its lanes' alive flags for the ordering before its first
// __syncthreads, before any lane is written.  No pointer is
// __restrict__, and only labels, media and det_geom, which no launch
// writes, are read through __ldg.
extern "C" int photon_step_launch(const void* const* in, void* const* out,
                                  const int* ints, const float* floats,
                                  void* const* tail,
                                  const long long* records, void* stream) {
  const int n = ints[0], groups = ints[9], n_det = ints[10],
            n_media = ints[11], jac_cols = ints[12], scenarios = ints[13],
            labels_stride = ints[14], add_into = ints[15],
            threads = ints[16], blocks = ints[17];
  if (groups != PS_GROUPS || threads != kThreads ||
      (long long)blocks * kThreads < n || (n > 0 && blocks <= 0) ||
      scenarios < 1 || scenarios > 65535 || (tail != nullptr && n <= 0) ||
      (records != nullptr &&
       (tail == nullptr || !kRecord || records[6] < 1)))
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
  a.errors = (int*)in[10];
  a.pos_out = (float*)out[0];
  a.dir_out = (float*)out[1];
  a.ivox_out = (int32_t*)out[2];
  a.w_out = (float*)out[3];
  a.s_out = (float*)out[4];
  a.t_out = (float*)out[5];
  a.rng_out = (int64_t*)out[6];
  a.alive_out = (uint8_t*)out[7];
  a.fluence = (u64*)out[8];
  a.exitance = (u64*)out[9];
  a.esc_out = (float*)out[10];
  a.timed_out = (float*)out[11];
  a.labels_stride = labels_stride;
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
  int i_in = 11, i_out = 12;
  if (kDet) {
    grp.ppath_in = (const float*)in[i_in++];
    grp.det_geom = (const float*)in[i_in++];
    grp.ppath_out = (float*)out[i_out++];
    grp.det_w = (u64*)out[i_out++];
    grp.det_ppath = (u64*)out[i_out++];
  }
  if (kJac) {
    grp.jac_w = (const float*)in[i_in++];
    grp.jac_col = (const int32_t*)in[i_in++];
  }
  if (kRecord) {
    grp.cap_det = (int32_t*)out[i_out++];
    grp.cap_gate = (int32_t*)out[i_out++];
  }
  if (kJac) grp.jac = (u64*)out[i_out++];
  if (kStats) grp.stats = (float*)out[i_out++];
  grp.n_det = n_det;
  grp.n_media = n_media;
  grp.jac_cols = jac_cols;
  if (tail != nullptr) {
    a.tail.escaped = (u64*)tail[0];
    a.tail.timed = (u64*)tail[1];
    a.tail.rounds = (long long*)tail[2];
    a.tail.work = (uint8_t*)tail[3];
    a.tail.more = (uint8_t*)tail[4];
    a.tail.remaining = (const long long*)tail[5];
    a.tail.flags = (unsigned*)tail[6];
  }
  if (records != nullptr) {
    a.rec.rec = (long long*)records[0];
    a.rec.kept = (long long*)records[1];
    a.rec.overflow = (long long*)records[2];
    a.rec.lane_ids = (const long long*)records[3];
    a.rec.counts = (unsigned*)records[4];
    a.rec.rows = (long long*)records[5];
    a.rec.capacity = records[6];
  }

  const size_t sc = (size_t)scenarios;
  const struct { void* p; size_t bytes; } zero[] = {
      {a.fluence, 8 * sc * nvox * a.ntg},
      {a.exitance, 8 * sc * a.nx * a.ny},
      {grp.det_w, 8 * sc * n_det * a.ntg},
      {grp.det_ppath, 8 * sc * n_det * n_media},
      {grp.jac, 8 * sc * nvox * jac_cols}};
  for (const auto& z : zero) {
    if (add_into || z.p == nullptr || z.bytes == 0) continue;
    const cudaError_t err = cudaMemsetAsync(z.p, 0, z.bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n <= 0) return 0;
  const bool do_reflect = ints[7] != 0, taylor = ints[8] != 0;
  cudaError_t err;
  if (do_reflect) {
    err = taylor ? launch<true, true>(a, blocks, scenarios, s)
                 : launch<true, false>(a, blocks, scenarios, s);
  } else {
    err = taylor ? launch<false, true>(a, blocks, scenarios, s)
                 : launch<false, false>(a, blocks, scenarios, s);
  }
  return (int)err;
}

extern "C" int photon_step_groups() { return PS_GROUPS; }

// The kernel's compile-time launch constants, which the wrapper checks
// against its own: threads a block, deposit-cache slots, pointers of the
// round's tail, words of the round's records.
extern "C" int photon_step_threads() { return kThreads; }
extern "C" int photon_step_cache_slots() { return kCacheSlots; }
extern "C" int photon_step_tail_words() { return kTailWords; }
extern "C" int photon_step_record_words() { return kRecordWords; }

extern "C" const char* photon_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
