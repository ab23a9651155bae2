// Host-side native runtime components for the radar SLAM engine.
//
// The reference implements its entire runtime in C++ (ROS nodes, PCL point
// cloud handling, Bresenham raytracing).  This engine keeps the compute
// path in XLA; these are the host-side pieces where native code still pays:
//
//  * pack_polar_image  — converts unorganized (x, y, intensity) radar point
//    clouds (the reference's input format, sensor_msgs/PointCloud2 ->
//    pcl::PointCloud, RS/src/radar_preprocessing/radar_preprocessor.cpp:45-60)
//    into the dense polar intensity images the device pipeline consumes.
//    This is the data-loader hot path when replaying real rosbag exports.
//
//  * bresenham_raytrace — integer ray walk with the same counting-grid
//    semantics as the reference (free cells -1 along the ray, +2 at the hit
//    cell, RS/src/ndt_representation/ndt_hierarchical_map.cpp:87-149), used
//    as the golden oracle for the device raytracer and for fast host-side
//    OGM export.  Derivation matches the device kernel
//    (randt_slam_tpu/mapping/raytrace.py): the classic incremental error
//    accumulator is replaced by the closed-form minor-axis progression
//        b(i) = (abs_da/2 + i*abs_db) / abs_da,
//    and out-of-bounds cells are skipped per-axis (the reference bounds-
//    checks only the FLAT offset, letting exiting rays wrap across rows and
//    stop; the device kernel fixes that deliberately and this oracle matches
//    the device).
//
// Built as a plain shared library; Python binds via ctypes (randt_slam_tpu/io/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Scatter n points (x, y, intensity) into an (A x R) polar image.
// Azimuth rows are uniform: azimuth0 + k * azimuth_step (wrapping).
// Range bins: r0 + j * bin_width.  Intensities max-combine per bin.
void pack_polar_image(const float* xyi, int64_t n_points,
                      float azimuth0, float azimuth_step, int64_t n_azimuths,
                      float r0, float bin_width, int64_t n_bins,
                      float* out_image) {
  std::memset(out_image, 0, sizeof(float) * n_azimuths * n_bins);
  const float two_pi = 6.28318530717958647692f;
  for (int64_t i = 0; i < n_points; ++i) {
    const float x = xyi[3 * i + 0];
    const float y = xyi[3 * i + 1];
    const float inten = xyi[3 * i + 2];
    const float r = std::hypot(x, y);
    const float a = std::atan2(y, x);
    float rel = (a - azimuth0) / azimuth_step;
    rel -= std::floor(rel / (two_pi / azimuth_step)) * (two_pi / azimuth_step);
    int64_t ai = (int64_t)std::lround(rel);
    if (ai < 0 || ai >= n_azimuths) ai = ((ai % n_azimuths) + n_azimuths) % n_azimuths;
    const int64_t ri = (int64_t)std::floor((r - r0) / bin_width);
    if (ri < 0 || ri >= n_bins) continue;
    float* cell = &out_image[ai * n_bins + ri];
    if (inten > *cell) *cell = inten;
  }
}

namespace {

inline int64_t isign(int64_t v) { return (v > 0) - (v < 0); }

// Closed-form integer ray walk (same derivation as the device kernel,
// mapping/raytrace.py ray_cells): step i along the dominant axis puts the
// minor axis at b(i) = (abs_da/2 + i*abs_db) / abs_da — identical cells to
// the incremental-error Bresenham, but each step is independent.
inline void trace_ray(int32_t* grid, int64_t W, int64_t H,
                      int64_t x0, int64_t y0, int64_t dx, int64_t dy,
                      int64_t max_steps) {
  const int64_t abs_dx = std::llabs(dx);
  const int64_t abs_dy = std::llabs(dy);
  const bool x_major = abs_dx >= abs_dy;
  const int64_t abs_da = x_major ? abs_dx : abs_dy;
  const int64_t abs_db = x_major ? abs_dy : abs_dx;
  const int64_t sa = x_major ? isign(dx) : isign(dy);
  const int64_t sb = x_major ? isign(dy) : isign(dx);
  const int64_t da = std::max<int64_t>(abs_da, 1);

  const int64_t n = std::min<int64_t>(max_steps, abs_da);
  // hit cell: position after the final step (skip its free-space decrement)
  const int64_t b_end = (abs_da / 2 + n * abs_db) / da;
  const int64_t ex = x_major ? x0 + n * sa : x0 + b_end * sb;
  const int64_t ey = x_major ? y0 + b_end * sb : y0 + n * sa;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t b = (abs_da / 2 + i * abs_db) / da;
    const int64_t ix = x_major ? x0 + i * sa : x0 + b * sb;
    const int64_t iy = x_major ? y0 + b * sb : y0 + i * sa;
    if (ix < 0 || ix >= W || iy < 0 || iy >= H) continue;
    if (ix == ex && iy == ey) continue;
    grid[iy * W + ix] -= 1;  // free space
  }
  if (ex >= 0 && ex < W && ey >= 0 && ey < H) {
    grid[ey * W + ex] += 2;  // occupied
  }
}

}  // namespace

// Trace n rays into an (H x W) int32 counting grid with resolution res.
// origins: (n, 3) sensor poses [x, y, theta] in the grid frame; rays leave at
// pose theta + beam angle with the given ranges (matching
// HierarchicalMap::raytraceLine, ndt_hierarchical_map.cpp:87-124).
void bresenham_raytrace(int32_t* grid, int64_t H, int64_t W, float res,
                        const float* origins, const float* angles,
                        const float* ranges, const uint8_t* valid,
                        int64_t n_rays) {
  for (int64_t k = 0; k < n_rays; ++k) {
    if (!valid[k]) continue;
    const float ox = origins[3 * k + 0];
    const float oy = origins[3 * k + 1];
    const float th = origins[3 * k + 2] + angles[k];
    const float r = ranges[k];
    const float ex = ox + std::cos(th) * r;
    const float ey = oy + std::sin(th) * r;

    const int64_t dx = (int64_t)((ex - ox) / res);
    const int64_t dy = (int64_t)((ey - oy) / res);
    const int64_t x0 = (int64_t)(ox / res + W / 2);
    const int64_t y0 = (int64_t)(oy / res + H / 2);

    // ray-length cap in dominant-axis steps (raytraceLine scale, :105-106)
    const int64_t abs_da = std::max(std::llabs(dx), std::llabs(dy));
    const double dist = std::hypot((double)dx, (double)dy);
    const double max_len_cells = (2.0 * r) / res;
    const double scale =
        (dist == 0.0) ? 1.0 : std::min(1.0, max_len_cells / dist);
    trace_ray(grid, W, H, x0, y0, dx, dy, (int64_t)(scale * (double)abs_da));
  }
}

// Fuse per-submap counting grids into the global counting grid — the
// MasterMap::getOGM resampling loop (ndt_master_map.cpp:20-79): each submap
// cell is forward-splatted with 4 anti-aliasing samples (offsets applied in
// the submap frame, :60-63); per (target cell, submap) only the max-magnitude
// increment counts (:65-67); increments sum across submaps (:72-77).
//
// submap_counts: (n_sub, sh, sw) int32; origins_rel: (n_sub, 3) pose of each
// submap OGM origin in the global OGM-origin frame.  out: (gh*gw) float32,
// pre-zeroed by the caller.  Scratch: caller-provided pos/neg float32 arrays
// of gh*gw (reused across submaps to keep the memory bound flat).
void fuse_counting_grids(const int32_t* submap_counts, int64_t n_sub,
                         int64_t sh, int64_t sw,
                         const float* origins_rel,
                         float sub_res, float glob_res,
                         int64_t gh, int64_t gw,
                         float* pos_scratch, float* neg_scratch,
                         float* out) {
  const int64_t n_glob = gh * gw;
  static const float offs[4][2] = {
      {-0.25f, -0.25f}, {-0.25f, 0.25f}, {0.25f, -0.25f}, {0.25f, 0.25f}};
  for (int64_t s = 0; s < n_sub; ++s) {
    std::memset(pos_scratch, 0, sizeof(float) * n_glob);
    std::memset(neg_scratch, 0, sizeof(float) * n_glob);
    const int32_t* counts = submap_counts + s * sh * sw;
    const float ox = origins_rel[3 * s + 0];
    const float oy = origins_rel[3 * s + 1];
    const float c = std::cos(origins_rel[3 * s + 2]);
    const float sn = std::sin(origins_rel[3 * s + 2]);
    for (int64_t iy = 0; iy < sh; ++iy) {
      for (int64_t ix = 0; ix < sw; ++ix) {
        const float v = (float)counts[iy * sw + ix];
        if (v == 0.0f) continue;
        const float lx = ix * sub_res;
        const float ly = iy * sub_res;
        for (int k = 0; k < 4; ++k) {
          const float px = lx + offs[k][0] * glob_res;
          const float py = ly + offs[k][1] * glob_res;
          const float gxf = (c * px - sn * py + ox) / glob_res;
          const float gyf = (sn * px + c * py + oy) / glob_res;
          const int64_t gx = (int64_t)std::floor(gxf);
          const int64_t gy = (int64_t)std::floor(gyf);
          if (gx < 0 || gx >= gw || gy < 0 || gy >= gh) continue;
          const int64_t t = gy * gw + gx;
          if (v > 0.0f) {
            if (v > pos_scratch[t]) pos_scratch[t] = v;
          } else {
            if (-v > neg_scratch[t]) neg_scratch[t] = -v;
          }
        }
      }
    }
    for (int64_t t = 0; t < n_glob; ++t) {
      const float inc =
          (pos_scratch[t] >= neg_scratch[t]) ? pos_scratch[t] : -neg_scratch[t];
      out[t] += inc;
    }
  }
}

}  // extern "C"
