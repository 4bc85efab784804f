// The shade stage: the sun's cone sample with the shadow-ray setup, and the
// fused shading of one bounce.
//
// Replaces: ptx/kernels/shade_pallas.py::_sun_kernel (launched by _call_sun)
// and the kernel built by _make_shade_kernel (launched by _call_shade).
//
//   ptx_shadow_rays: PCG4D theta / phi draws, a cone about the sun direction
//              with the reference's non-parallel-axis basis and exists =
//              (n . d > 0) & alive; then the shadow rays as the any sweep
//              reads them: [R_pad, 8] rows (p + d * EPS, d, 0, 0), lanes
//              without exists & hit parked outside the scene when survivor
//              compaction is on (sorting.park), padding rows (0,0,0,1,0,0,
//              0,0) (tiles._pack_rays).  One launch in place of the sun
//              kernel, the park and the pack.
//   ptx_shade: env on a miss, emission x scale, stochastic opacity, TBN +
//              normal map, backface cull, first-bounce shadow catcher, lobe
//              pick, sun NEE (HAS_SUN), GGX / cosine importance sampling,
//              throughput clamps, Russian roulette and the lane merges, with
//              the Pallas kernel's semantics (dead lanes' origins become 0,
//              alive = alive & (passthrough | continues)).
// The plain torch versions (_shadow_rays, _shade in kernels/shade_cuda.py)
// run the same operations in the same order.  With -fmad=false each
// operation rounds once, as in torch; the remaining care points:
//   * constants are single f32 roundings of the JAX package's python floats
//     ((float)(2.0 * PI), 1e-4f); x / PI is x * f32(1 / f32(PI)), which is
//     what XLA makes of a division by a constant and what torch does for a
//     division by a python scalar on the card;
//   * normalisation is rsqrtf(max(x*x + y*y + z*z, 1e-20)), as torch.rsqrt;
//   * max / min / clamp keep a NaN like jnp.maximum and torch.maximum (fmaxf
//     alone drops it);
//   * p^5 is p*p*p*p*p, never powf.
//
// Bound on the card: one thread per ray, no reuse between rays, so the
// stage is bound by device memory: ~190 bytes read and ~50 written per ray
// (the state, hit, material and sun tensors; each is read in place through
// a (pointer, stride) pair, so no copy kernel gathers views first) against
// ~600 flops.  The shadow-ray setup reads 34 bytes and writes 45 per lane
// (and 32 per padding row).  The design point is the launch count: the
// plain torch stage is ~1,000 small kernels per bounce, this is two.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1.0e-4f;
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979);
constexpr float PI_F = (float)3.14159265358979;
constexpr float INV_PI = 0x1.45f306p-2f;  // f32(1 / f32(PI))
constexpr float INV_SQRT3 = (float)0.5773502691896258;

constexpr uint32_t P_SUN_PHI = 0x03;
constexpr uint32_t P_SUN_THETA = 0x04;
constexpr uint32_t P_OPACITY = 0x05;
constexpr uint32_t P_LOBE = 0x06;
constexpr uint32_t P_BRDF_U = 0x07;
constexpr uint32_t P_BRDF_V = 0x08;
constexpr uint32_t P_RR = 0x09;

}  // namespace

// One per-ray input: element i (or the first component of row i) at
// p[i * s]; a [R, 3] input has unit column stride.
struct Col {
  const void* p;
  long long s;
};

struct ShadowArgs {
  Col pix, smp, alive, hit, normal, position;
  float* out_dir;        // [n, 3] the sun sample, for the shade kernel
  uint8_t* out_exists;   // [n] bool
  float4* out_rays;      // [n_pad, 8] ray rows, 32-byte aligned
  long long n, n_pad;
  uint32_t it, seed;
  float sun_dir[3];
  float angular_radius;
  int park;              // park the lanes without exists & hit
  float park_org[3];     // hi + (hi - lo) + 1 of the scene box
  float park_dir;        // f32(0.57735027)
};

struct ShadeArgs {
  // RayState
  Col pix, smp, dirn, radiance, throughput, alpha, alive, bounce;
  // Hit
  Col hit, position, normal, tangent;
  // material_lookup
  Col albedo, opacity, roughness, metallic, ior, catcher, emissive, tnormal;
  // environment radiance, sun sample and shadow ray
  Col env, d_sun, sun_exists, shadow_hit;
  // next RayState (contiguous)
  float* out_orig;
  float* out_dirn;
  float* out_radiance;
  float* out_throughput;
  float* out_alpha;
  uint8_t* out_alive;
  int* out_bounce;
  long long n;
  uint32_t it, seed;
  int bounces, rr_limit;
  float alpha_on_miss, emissive_scale, roughness_floor, throughput_clamp;
  int clamp_direct, indirect_clamp;
  float sun_energy[3];
};

namespace {

__device__ __forceinline__ float ldf(const Col& c, long long i, int k = 0) {
  return static_cast<const float*>(c.p)[i * c.s + k];
}
__device__ __forceinline__ int ldi(const Col& c, long long i) {
  return static_cast<const int*>(c.p)[i * c.s];
}
__device__ __forceinline__ bool ldb(const Col& c, long long i) {
  return static_cast<const uint8_t*>(c.p)[i * c.s] != 0;
}

// jnp.maximum / torch.maximum: a NaN operand propagates.
__device__ __forceinline__ float vmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float vmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return vmin(vmax(x, lo), hi);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const Col& c, long long i) {
  return {ldf(c, i, 0), ldf(c, i, 1), ldf(c, i, 2)};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = rsqrtf(vmax(a.x * a.x + a.y * a.y + a.z * a.z, 1e-20f));
  return {a.x * inv, a.y * inv, a.z * inv};
}

// PCG4D -> uniform [0, 1) (sampling._pcg4d on native uint32).
__device__ __forceinline__ float uniform(uint32_t pix, uint32_t smp,
                                         uint32_t it, uint32_t purpose,
                                         uint32_t seed) {
  const uint32_t k = 1664525u, m = 1013904223u;
  uint32_t a = pix * k + m;
  uint32_t b = smp * k + m;
  uint32_t c = ((it << 8) | purpose) * k + m;
  uint32_t d = (seed ^ 0x9E3779B9u) * k + m;
  a = a + b * d;
  b = b + c * a;
  c = c + a * b;
  d = d + b * c;
  a = a ^ (a >> 16);
  b = b ^ (b >> 16);
  c = c ^ (c >> 16);
  d = d ^ (d >> 16);
  a = a + b * d;
  return (float)(a >> 8) * (1.0f / 16777216.0f);
}

// rand_cone_vec: a direction at cos_theta about axis, azimuth u * 2 pi,
// with the reference's tangent frame (util/rand_cone_vec.cpp:20-33).
__device__ __forceinline__ V3 cone(float u, float cos_theta, V3 ax) {
  const float phi = u * TWO_PI;
  const float sin_theta = sqrtf(vmax(1.0f - cos_theta * cos_theta, 0.0f));
  const float lx = cosf(phi) * sin_theta;
  const float ly = sinf(phi) * sin_theta;
  const float lz = cos_theta;
  const bool use_x = fabsf(ax.x) < INV_SQRT3;
  const bool use_y = !use_x && fabsf(ax.y) < INV_SQRT3;
  const V3 e = {use_x ? 1.0f : 0.0f, use_y ? 1.0f : 0.0f,
                (use_x || use_y) ? 0.0f : 1.0f};
  const V3 t = normalize(cross(ax, e));
  const V3 b = cross(ax, t);
  return {t.x * lx + b.x * ly + ax.x * lz, t.y * lx + b.y * ly + ax.y * lz,
          t.z * lx + b.z * ly + ax.z * lz};
}

__device__ __forceinline__ float fresnel(V3 o, V3 i, float ior) {
  const V3 h = normalize({o.x + i.x, o.y + i.y, o.z + i.z});
  const float cos_t = dot(o, h);
  float f0 = (ior - 1.0f) / (ior + 1.0f);
  f0 = f0 * f0;
  const float p = vmax(1.0f - cos_t, 0.0f);
  const float p5 = p * p * p * p * p;
  return f0 + (1.0f - f0) * p5;
}

__device__ __forceinline__ float smith_g1(float cos_theta, float k) {
  return cos_theta / vmax(k + (1.0f - k) * cos_theta, EPS);
}

struct Brdf {
  V3 f;
  float diffuse_pdf, specular_pdf;
};

// shading_worker.cpp:118-139 (shade_pallas._brdf_block).
__device__ __forceinline__ Brdf brdf_block(V3 n, V3 o, V3 i, V3 alb,
                                           float metal, float rough) {
  const float n_dot_i = dot(n, i);
  const float n_dot_o = dot(n, o);
  const float diffuse_pdf = n_dot_i * INV_PI;
  float a = rough * rough;
  a = a * a;
  const V3 h = normalize({o.x + i.x, o.y + i.y, o.z + i.z});
  const float cos_phi = dot(n, h);
  const float denom = 1.0f + (a - 1.0f) * cos_phi * cos_phi;
  const float dist = n_dot_i * a / vmax(PI_F * denom * denom, EPS);
  const float r1 = rough + 1.0f;
  const float k = (r1 * r1) / 8.0f;
  const float geo = smith_g1(n_dot_o, k) * smith_g1(n_dot_i, k);
  const float specular_pdf = (dist * geo) / vmax(4.0f * n_dot_o * n_dot_i, EPS);
  const float cos_oh = dot(o, h);
  const float p = vmax(1.0f - cos_oh, 0.0f);
  const float p5 = p * p * p * p * p;
  const float inv_m = 1.0f - metal;
  auto channel = [&](float c) {
    const float fres = (0.04f + (c - 0.04f) * metal) * (1.0f - p5) + p5;
    const float diffuse = diffuse_pdf * c * inv_m;
    return diffuse + (specular_pdf - diffuse) * fres;
  };
  return {{channel(alb.x), channel(alb.y), channel(alb.z)}, diffuse_pdf,
          specular_pdf};
}

// One thread per ray row, n_pad of them.  A lane i < n draws the sun sample
// (d_sun, exists) and writes its shadow ray row (p + d * EPS, d), or the
// parked row when parking is on and the lane lacks exists & hit; a row
// n <= i < n_pad is padding (0,0,0, 1,0,0, 0,0).  Each row is two 16-byte
// stores.  SUN_THREADS is small so that a chunk of 8,192 lanes spreads
// over 128 CTAs, about one per SM.
constexpr int SUN_THREADS = 64;

__global__ void __launch_bounds__(SUN_THREADS)
    shadow_rays_kernel(const ShadowArgs a) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.n_pad) return;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  float4 hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < a.n) {
    const uint32_t pix = (uint32_t)ldi(a.pix, i), smp = (uint32_t)ldi(a.smp, i);
    const float u_theta = uniform(pix, smp, a.it, P_SUN_THETA, a.seed);
    const float u_phi = uniform(pix, smp, a.it, P_SUN_PHI, a.seed);
    const float cos_t = cosf(u_theta * a.angular_radius);
    const V3 d = cone(u_phi, cos_t, {a.sun_dir[0], a.sun_dir[1], a.sun_dir[2]});
    const V3 n = ld3(a.normal, i);
    const V3 p = ld3(a.position, i);
    const bool exists = (dot(n, d) > 0.0f) && ldb(a.alive, i);
    float* dir = a.out_dir + i * 3;
    dir[0] = d.x;
    dir[1] = d.y;
    dir[2] = d.z;
    a.out_exists[i] = exists;
    if (a.park && !(exists && ldb(a.hit, i))) {
      const float w = a.park_dir;
      lo = make_float4(a.park_org[0], a.park_org[1], a.park_org[2], w);
      hi = make_float4(w, w, 0.0f, 0.0f);
    } else {
      lo = make_float4(p.x + d.x * EPS, p.y + d.y * EPS, p.z + d.z * EPS, d.x);
      hi = make_float4(d.y, d.z, 0.0f, 0.0f);
    }
  }
  a.out_rays[2 * i] = lo;
  a.out_rays[2 * i + 1] = hi;
}

template <bool HAS_SUN>
__global__ void __launch_bounds__(256) shade_kernel(const ShadeArgs a) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const uint32_t pix = (uint32_t)ldi(a.pix, i), smp = (uint32_t)ldi(a.smp, i);
  auto u = [&](uint32_t purpose) {
    return uniform(pix, smp, a.it, purpose, a.seed);
  };

  const bool alive_in = ldb(a.alive, i);
  const bool hit = ldb(a.hit, i) && alive_in;
  const bool miss = alive_in && !hit;
  const V3 d = ld3(a.dirn, i);
  const V3 thr = ld3(a.throughput, i);

  // miss -> environment (shading_worker.cpp:27-41)
  const float mf = miss ? 1.0f : 0.0f;
  const V3 env = ld3(a.env, i);
  V3 rad = ld3(a.radiance, i);
  rad = {rad.x + mf * thr.x * env.x, rad.y + mf * thr.y * env.y,
         rad.z + mf * thr.z * env.z};
  float alpha = miss ? a.alpha_on_miss : ldf(a.alpha, i);
  const bool alive = alive_in && hit;
  alpha = hit ? 1.0f : alpha;

  // emissive (x scale quirk)
  const float af = alive ? 1.0f : 0.0f;
  const float es = a.emissive_scale;
  const V3 emi = ld3(a.emissive, i);
  rad = {rad.x + af * thr.x * emi.x * es, rad.y + af * thr.y * emi.y * es,
         rad.z + af * thr.z * emi.z * es};

  // stochastic opacity passthrough (no bounce consumed)
  const float opacity = ldf(a.opacity, i);
  const bool translucent = fabsf(opacity - 1.0f) > EPS;
  bool passthrough = alive && translucent && (u(P_OPACITY) > opacity);

  // shading normal: TBN + normal map (intersect.cpp:71-77)
  const V3 n = normalize(ld3(a.normal, i));
  const V3 tg = normalize(ld3(a.tangent, i));
  const V3 b = cross(n, tg);
  const V3 tn = ld3(a.tnormal, i);
  const V3 s = normalize({tg.x * tn.x + b.x * tn.y + n.x * tn.z,
                          tg.y * tn.x + b.y * tn.y + n.y * tn.z,
                          tg.z * tn.x + b.z * tn.y + n.z * tn.z});
  const V3 o = {-d.x, -d.y, -d.z};

  const float n_dot_o = dot(s, o);
  const bool backface = alive && !passthrough && (n_dot_o <= 0.0f);

  bool sun_exists = false, shadow_hit = false;
  V3 sd = {0.0f, 0.0f, 0.0f};
  if (HAS_SUN) {
    sun_exists = ldb(a.sun_exists, i);
    shadow_hit = ldb(a.shadow_hit, i);
    sd = ld3(a.d_sun, i);
  }
  const float n_dot_sun = dot(s, sd);

  // shadow catcher at the first bounce (shading_worker.cpp:74-105)
  const int bounce = ldi(a.bounce, i);
  const bool is_catcher = ldf(a.catcher, i) > 0.5f;
  const bool first_bounce = bounce == a.bounces;
  const bool catcher_now =
      alive && !passthrough && !backface && is_catcher && first_bounce;
  const bool catcher_lit = HAS_SUN && catcher_now && sun_exists &&
                           (n_dot_sun > 0.0f) && !shadow_hit;
  const bool catcher_shadowed = catcher_now && !catcher_lit;
  const float csf = 1.0f - (catcher_shadowed ? 1.0f : 0.0f);
  rad = {rad.x * csf, rad.y * csf, rad.z * csf};
  alpha = catcher_shadowed ? 1.0f : alpha;
  passthrough = passthrough || catcher_lit;

  // lobe selection; mirror = reflect(-out, n)
  const float rough = vmax(ldf(a.roughness, i), a.roughness_floor);
  const float metal = ldf(a.metallic, i);
  const float d_dot_n = dot(s, d);
  const V3 mir = {d.x - 2.0f * d_dot_n * s.x, d.y - 2.0f * d_dot_n * s.y,
                  d.z - 2.0f * d_dot_n * s.z};
  const float spec_prob = vmax(fresnel(o, mir, ldf(a.ior, i)), metal);
  const bool specular_sample = u(P_LOBE) < spec_prob;

  const bool shading = alive && !passthrough && !backface && !catcher_shadowed;
  const V3 alb = ld3(a.albedo, i);

  // NEE (shading_worker.cpp:112-147): pdf = 1, clamped to the sun energy
  if (HAS_SUN) {
    const bool nee_ok =
        shading && sun_exists && (n_dot_sun > 0.0f) && !shadow_hit;
    const Brdf nb = brdf_block(s, o, sd, alb, metal, rough);
    const float se_r = a.sun_energy[0], se_g = a.sun_energy[1],
                se_b = a.sun_energy[2];
    float d_r = nb.f.x * se_r, d_g = nb.f.y * se_g, d_b = nb.f.z * se_b;
    if (a.clamp_direct) {
      d_r = clip(d_r, 0.0f, se_r);
      d_g = clip(d_g, 0.0f, se_g);
      d_b = clip(d_b, 0.0f, se_b);
    }
    const float nf = nee_ok ? 1.0f : 0.0f;
    rad = {rad.x + nf * thr.x * d_r, rad.y + nf * thr.y * d_g,
           rad.z + nf * thr.z * d_b};
  }

  // indirect importance sampling (shading_worker.cpp:149-199)
  const float u1 = u(P_BRDF_U);
  const float u2 = u(P_BRDF_V);
  float a4 = rough * rough;
  a4 = a4 * a4;
  const float ggx_cos =
      sqrtf(clip((1.0f - u1) / (1.0f + (a4 - 1.0f) * u1), 0.0f, 1.0f));
  const V3 h = cone(u2, ggx_cos, s);
  const float o_dot_h = dot(h, o);
  const V3 sp = {2.0f * o_dot_h * h.x - o.x, 2.0f * o_dot_h * h.y - o.y,
                 2.0f * o_dot_h * h.z - o.z};
  // cosine-weighted: the reference's cos(acos(2u-1)/2) is sqrt(u)
  const V3 df = cone(u2, sqrtf(u1), s);
  const V3 in = specular_sample ? sp : df;

  const bool up_facing = dot(s, in) > 0.0f;
  const Brdf ib = brdf_block(s, o, in, alb, metal, rough);
  const float pdf =
      ib.diffuse_pdf + (ib.specular_pdf - ib.diffuse_pdf) * spec_prob;
  const float inv_pdf = 1.0f / vmax(pdf, EPS);
  V3 nthr;
  if (a.indirect_clamp) {
    // monolithic convention: per-bounce factor clamped to 1
    nthr = {thr.x * clip(ib.f.x * inv_pdf, 0.0f, 1.0f),
            thr.y * clip(ib.f.y * inv_pdf, 0.0f, 1.0f),
            thr.z * clip(ib.f.z * inv_pdf, 0.0f, 1.0f)};
  } else {
    const float tc = a.throughput_clamp;
    nthr = {clip(thr.x * ib.f.x * inv_pdf, 0.0f, tc),
            clip(thr.y * ib.f.y * inv_pdf, 0.0f, tc),
            clip(thr.z * ib.f.z * inv_pdf, 0.0f, tc)};
  }

  // Russian roulette (shading_worker.cpp:182-190)
  const bool rr_active = bounce < a.rr_limit;
  const float p_survive = vmax(nthr.x, vmax(nthr.y, nthr.z));
  const bool rr_kill = rr_active && (u(P_RR) > p_survive);
  const float comp =
      (rr_active && !rr_kill) ? 1.0f / vmax(p_survive, EPS) : 1.0f;
  nthr = {nthr.x * comp, nthr.y * comp, nthr.z * comp};

  const int new_bounce = bounce - 1;
  const bool continues = shading && up_facing && !rr_kill && (new_bounce > 0);

  // lane merges
  const V3 p = ld3(a.position, i);
  float* orig = a.out_orig + i * 3;
  float* dirn = a.out_dirn + i * 3;
  float* radiance = a.out_radiance + i * 3;
  float* throughput = a.out_throughput + i * 3;
  orig[0] = passthrough ? p.x + d.x * EPS : (continues ? p.x + in.x * EPS : 0.0f);
  orig[1] = passthrough ? p.y + d.y * EPS : (continues ? p.y + in.y * EPS : 0.0f);
  orig[2] = passthrough ? p.z + d.z * EPS : (continues ? p.z + in.z * EPS : 0.0f);
  dirn[0] = continues ? in.x : d.x;
  dirn[1] = continues ? in.y : d.y;
  dirn[2] = continues ? in.z : d.z;
  throughput[0] = continues ? nthr.x : thr.x;
  throughput[1] = continues ? nthr.y : thr.y;
  throughput[2] = continues ? nthr.z : thr.z;
  radiance[0] = rad.x;
  radiance[1] = rad.y;
  radiance[2] = rad.z;
  a.out_alpha[i] = alpha;
  a.out_bounce[i] = continues ? new_bounce : bounce;
  a.out_alive[i] = alive && (passthrough || continues);
}

constexpr int THREADS = 256;

int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int ptx_shadow_rays(const ShadowArgs* args, void* stream) {
  if (args->n_pad > 0)
    shadow_rays_kernel<<<(int)((args->n_pad + SUN_THREADS - 1) / SUN_THREADS),
                         SUN_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int ptx_shade(const ShadeArgs* args, int has_sun, void* stream) {
  if (args->n > 0) {
    if (has_sun)
      shade_kernel<true>
          <<<blocks_for(args->n), THREADS, 0, (cudaStream_t)stream>>>(*args);
    else
      shade_kernel<false>
          <<<blocks_for(args->n), THREADS, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
