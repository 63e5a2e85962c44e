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
// What bounds it: per live lane-segment it reads 2 labels (1 B each,
//   from L2: the 216 KB label grid of a 60^3 volume stays resident in
//   the 50 MB L2) and 2 media rows, draws 5 xorshift128 uniforms, and
//   does ~130 float32 operations and ~18 special-function operations
//   (log, exp, sin, cos, square roots, reciprocals of the IEEE
//   divisions); the state (81 B a lane) is read and written once per
//   launch and every deposit is a 4 B atomic.  chip_smoke.py counts
//   these for its inputs: at 262144 lanes x 16 segments the bytes
//   (0.018 ms at 3.35 TB/s) and the special-function units (0.017 ms)
//   bound it about equally, while one launch took 0.25 ms on an H100
//   80GB HBM3 at 700 W.  Warp divergence (scatter vs wall crossing vs
//   Fresnel) and atomic contention near the source are the likely
//   losses.  The groups add little: DET reads and writes the lane's
//   per-medium path (4 B a medium each way) and updates one entry of it
//   per live segment in place (L1/L2), and each capture (at most one
//   per photon) adds 1 + n_media atomics; RECORD writes 8 B a lane;
//   STATS 8 B a lane; JAC reads 8 B a lane and adds one atomic per live
//   segment into an nvox x jac_cols grid (130 MB at 60^3 with 150
//   columns, far beyond L2, so those atomics go to HBM).
//
// What the design does about it: one thread per lane, 256 threads a
//   block, a tail-masked grid.  The state lives in registers across the
//   K segments and is written back once in the reference layout.  The
//   fluence, exitance, TPSF, path-sum and Jacobian sums use atomicAdd
//   on zero-initialised float32 buffers in device memory, indexed in
//   64 bits where a grid can pass 2^31 cells; an add of exactly zero
//   (dead lane, missed detector, padding lane) is skipped, so only
//   live segments touch memory.  The per-medium path stays in device
//   memory rather than registers, so n_media has no compile-time bound.
//   DO_REFLECT and TAYLOR are template flags so the specialised kernel
//   carries only its physics.
//
// Parity: the arithmetic follows repro_torch/core/photon.py and
//   repro_torch/detectors operation by operation.  Build with
//   --fmad=false and without fast math: every constant below is a float
//   literal, and logf/expf/sinf/cosf/sqrtf and IEEE division are what
//   PyTorch's elementwise CUDA operators call, so the per-lane state
//   (and ppath, cap_det, cap_gate and the stats block) matches the
//   plain version bit for bit where the operation order matches.  No
//   group writes a variable of the lane state, so the state and the
//   base outputs are the same with any group on or off.

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

template <bool DO_REFLECT, bool TAYLOR>
__global__ void __launch_bounds__(256) photon_step_kernel(
    const uint8_t* __restrict__ labels, const float* __restrict__ media,
    const float* __restrict__ pos_in, const float* __restrict__ dir_in,
    const int32_t* __restrict__ ivox_in, const float* __restrict__ w_in,
    const float* __restrict__ s_in, const float* __restrict__ t_in,
    const int64_t* __restrict__ rng_in, const uint8_t* __restrict__ alive_in,
    float* __restrict__ pos_out, float* __restrict__ dir_out,
    int32_t* __restrict__ ivox_out, float* __restrict__ w_out,
    float* __restrict__ s_out, float* __restrict__ t_out,
    int64_t* __restrict__ rng_out, uint8_t* __restrict__ alive_out,
    float* __restrict__ fluence, float* __restrict__ exitance,
    float* __restrict__ esc_out, float* __restrict__ timed_out,
    int n, int nx, int ny, int nz, float unit, int n_steps, int ntg,
    float gate_scale, float tmax, float w_threshold, float roulette_m,
    float roulette_p, int general_exact, const Groups grp) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  float p[3], d[3];
  int iv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = pos_in[3 * lane + a];
    d[a] = dir_in[3 * lane + a];
    iv[a] = ivox_in[3 * lane + a];
  }
  float w = w_in[lane], s = s_in[lane], t = t_in[lane];
  Rng r;
  r.x = (uint32_t)rng_in[4 * lane + 0];
  r.y = (uint32_t)rng_in[4 * lane + 1];
  r.z = (uint32_t)rng_in[4 * lane + 2];
  r.w = (uint32_t)rng_in[4 * lane + 3];
  bool alive = alive_in[lane] != 0;
  float esc_acc = 0.f, timed_acc = 0.f;

  // the lane's per-medium path, carried in its row of ppath_out
  float* pp = nullptr;
  if (kDet) {
    const int nm = grp.n_media;
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

  for (int k = 0; k < n_steps; ++k) {
    const int cx = clampi(iv[0], 0, nx - 1);
    const int cy = clampi(iv[1], 0, ny - 1);
    const int cz = clampi(iv[2], 0, nz - 1);
    const long long flat = ((long long)cx * ny + cy) * nz + cz;
    const int label = __ldg(labels + flat);
    const float mua = __ldg(media + 4 * label + 0) * unit;
    const float mus = __ldg(media + 4 * label + 1) * unit;
    const float g = __ldg(media + 4 * label + 2);
    const float n_cur = __ldg(media + 4 * label + 3);

    // --- the per-step uniforms: always 5, on every lane ---
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
      const float fv = (float)iv[a];
      float da;
      if (d[a] > kDirEps) {
        da = (fv + 1.f - p[a]) / d[a];
      } else if (d[a] < -kDirEps) {
        da = (fv - p[a]) / d[a];
      } else {
        da = kInf;
      }
      dist[a] = fmaxf(da, 0.f);
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
    const float t_new = t + seg * unit * n_cur / kCLight;

    // --- DROP ---
    const float tau = mua * seg;
    float dep, w_after;
    if (TAYLOR) {
      dep = w * fminf(tau, 1.f);
      w_after = w - dep;
    } else if (general_exact) {
      dep = w - w * expf(-tau);
      w_after = w - dep;
    } else {
      w_after = w * expf(-tau);
      dep = w - w_after;
    }

    // --- BOUNDARY: next voxel ---
    const float dir_axis = d[axis];
    const int sgn = dir_axis > 0.f ? 1 : (dir_axis < 0.f ? -1 : 0);
    int nv[3] = {iv[0], iv[1], iv[2]};
    nv[axis] += sgn;
    const bool oob = nv[0] < 0 || nv[0] >= nx || nv[1] < 0 || nv[1] >= ny ||
                     nv[2] < 0 || nv[2] >= nz;
    int next_label = 0;
    if (!oob) {
      next_label = __ldg(labels + ((long long)nv[0] * ny + nv[1]) * nz + nv[2]);
    }
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
      const float cosp = cosf(phi);
      const float sinp = sinf(phi);
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
      // --- Fresnel reflection / Snell refraction at an index mismatch ---
      const float n_next = __ldg(media + 4 * next_label + 3);
      const bool mismatch = fabsf(n_next - n_cur) > 1e-6f;
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
      reflects = mismatch && (u_fres < refl_r);
      if (reflects) {
        nd[axis] = d[axis] * -1.f;
      } else if (mismatch) {
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

    const bool escapes = crossing && !reflects && (oob || next_label == 0);
    const bool advances = crossing && !reflects && !escapes;

    // --- ROULETTE, then the time gate, then escape zeroing ---
    bool alive_after = alive && !escapes;
    const bool low_w = alive_after && (w_after < w_threshold);
    const bool survives = u_roul < roulette_p;
    float w_final = low_w ? (survives ? w_after * roulette_m : 0.f) : w_after;
    alive_after = alive_after && !(low_w && !survives);
    const bool gate_kill = alive_after && (t_new > tmax);
    alive_after = alive_after && !gate_kill;
    const float timed_w = gate_kill ? w_final : 0.f;
    const float esc_w = escapes ? w_after : 0.f;
    if (escapes) w_final = 0.f;

    if (kStats) {
      st_live = st_live + (alive ? 1.f : 0.f);
      st_dep = st_dep + (alive ? dep : 0.f);
    }
    if (alive) {
      // deposition (zero deposits add nothing and are skipped); the gate
      // is computed where it is used, so the base variant does no work
      // of the groups
      if (dep != 0.f) {
        const int gate = clampi((int)floorf(t_new * gate_scale), 0, ntg - 1);
        atomicAdd(fluence + flat * ntg + gate, dep);
      }
      const float seg_len = seg * unit;
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
                clampi((int)floorf(t_new * gate_scale), 0, ntg - 1);
            atomicAdd(grp.det_w + (long long)det * ntg + gate, esc_w);
            for (int m = 0; m < grp.n_media; ++m) {
              const float v = esc_w * pp[m];
              if (v != 0.f)
                atomicAdd(grp.det_ppath + (long long)det * grp.n_media + m, v);
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
          atomicAdd(grp.jac + flat * grp.jac_cols + jac_col, v);
      }
      if (esc_w > 0.f && np_[2] < kZExitFace) {
        const int ex = clampi((int)floorf(np_[0]), 0, nx - 1);
        const int ey = clampi((int)floorf(np_[1]), 0, ny - 1);
        atomicAdd(exitance + ex * ny + ey, esc_w);
      }
      esc_acc = esc_acc + esc_w;
      timed_acc = timed_acc + timed_w;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p[a] = np_[a];
        d[a] = nd[a];
      }
      if (advances) iv[axis] = nv[axis];
      w = w_final;
      s = s_new;
      t = t_new;
    }
    alive = alive_after;
  }

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pos_out[3 * lane + a] = p[a];
    dir_out[3 * lane + a] = d[a];
    ivox_out[3 * lane + a] = iv[a];
  }
  w_out[lane] = w;
  s_out[lane] = s;
  t_out[lane] = t;
  rng_out[4 * lane + 0] = (int64_t)r.x;
  rng_out[4 * lane + 1] = (int64_t)r.y;
  rng_out[4 * lane + 2] = (int64_t)r.z;
  rng_out[4 * lane + 3] = (int64_t)r.w;
  alive_out[lane] = alive ? 1 : 0;
  esc_out[lane] = esc_acc;
  timed_out[lane] = timed_acc;
  if (kRecord) {
    grp.cap_det[lane] = cap_det;
    grp.cap_gate[lane] = cap_gate;
  }
  if (kStats) {
    grp.stats[2 * lane + 0] = st_live;
    grp.stats[2 * lane + 1] = st_dep;
  }
}

template <bool DO_REFLECT, bool TAYLOR>
cudaError_t launch(const void* const* in, void* const* out, const int* ints,
                   const float* floats, cudaStream_t stream) {
  const int n = ints[0];
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  // the optional inputs and outputs follow the base ones, in the order
  // of the output contract (kernels/photon_step/spec.py)
  Groups grp = {};
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
  grp.n_det = ints[10];
  grp.n_media = ints[11];
  grp.jac_cols = ints[12];
  photon_step_kernel<DO_REFLECT, TAYLOR><<<blocks, threads, 0, stream>>>(
      (const uint8_t*)in[0], (const float*)in[1], (const float*)in[2],
      (const float*)in[3], (const int32_t*)in[4], (const float*)in[5],
      (const float*)in[6], (const float*)in[7], (const int64_t*)in[8],
      (const uint8_t*)in[9], (float*)out[0], (float*)out[1],
      (int32_t*)out[2], (float*)out[3], (float*)out[4], (float*)out[5],
      (int64_t*)out[6], (uint8_t*)out[7], (float*)out[8], (float*)out[9],
      (float*)out[10], (float*)out[11], n, ints[1], ints[2], ints[3],
      floats[0], ints[4], ints[5], floats[1], floats[2], floats[3],
      floats[4], floats[5], ints[6], grp);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   in:  labels, media, pos, dir, ivox, w, s_left, t, rng, alive (10),
//        then [ppath, det_geom] (DET), [jac_w, jac_col, errors] (JAC;
//        errors is one int32 the kernel ORs 1 into for a bad jac_col)
//   out: pos, dir, ivox, w, s_left, t, rng, alive, fluence, exitance,
//        escaped, timed (12), then [ppath, det_w, det_ppath] (DET),
//        [cap_det, cap_gate] (RECORD), [jac] (JAC), [stats] (STATS)
//   ints:   n, nx, ny, nz, n_steps, ntg, general_exact, do_reflect, taylor,
//           groups, n_det, n_media, jac_cols
//   floats: unit, gate_scale, tmax, w_threshold, roulette_m, roulette_p
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue when ``groups`` is not the set this library was
// built for.
extern "C" int photon_step_launch(const void* const* in, void* const* out,
                                  const int* ints, const float* floats,
                                  void* stream) {
  if (ints[9] != PS_GROUPS) return (int)cudaErrorInvalidValue;
  if (ints[0] <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool do_reflect = ints[7] != 0, taylor = ints[8] != 0;
  cudaError_t err;
  if (do_reflect) {
    err = taylor ? launch<true, true>(in, out, ints, floats, s)
                 : launch<true, false>(in, out, ints, floats, s);
  } else {
    err = taylor ? launch<false, true>(in, out, ints, floats, s)
                 : launch<false, false>(in, out, ints, floats, s);
  }
  return (int)err;
}

extern "C" int photon_step_groups() { return PS_GROUPS; }

extern "C" const char* photon_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
