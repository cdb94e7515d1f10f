// Native host-side geometry kernels for backtoreality-tpu.
//
// The reference's only native code is its CUDA op library; on TPU those
// ops are Pallas kernels. What remains hot on the *host* is the eval
// stack: VOC AP matching computes oriented-box IoU for every
// (detection, GT) pair per class (`utils/eval_det.py:128-141`), which
// the reference mitigates with a process pool. Here the pairwise IoU
// (Sutherland-Hodgman BEV clip x height overlap) is C++, exposed via a
// C ABI for ctypes.
//
// Conventions match eval/box3d.py: corners are (8, 3) in camera coords
// (y up), rows 0-3 top face, 4-7 bottom; the BEV polygon is rows 3..0
// of (x, z), counter-clockwise.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

double poly_area(const std::vector<P2>& p) {
  double a = 0.0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    const P2& u = p[i];
    const P2& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return std::fabs(a) * 0.5;
}

// Clip `subject` by the convex CCW polygon `clip` (Sutherland-Hodgman).
std::vector<P2> clip_polygon(std::vector<P2> subject,
                             const std::vector<P2>& clip) {
  std::vector<P2> output = std::move(subject);
  size_t m = clip.size();
  for (size_t c = 0; c < m && !output.empty(); ++c) {
    const P2 cp1 = clip[(c + m - 1) % m];
    const P2 cp2 = clip[c];
    const double ex = cp2.x - cp1.x;
    const double ey = cp2.y - cp1.y;
    std::vector<P2> input = std::move(output);
    output.clear();
    // boundary counts as inside; near-parallel intersections skipped
    // (matches eval/box3d.py's robustness fixes)
    auto inside = [&](const P2& p) {
      return ex * (p.y - cp1.y) >= ey * (p.x - cp1.x);
    };
    auto intersect = [&](const P2& s, const P2& e, P2* out_pt) {
      const double dcx = cp1.x - cp2.x, dcy = cp1.y - cp2.y;
      const double dpx = s.x - e.x, dpy = s.y - e.y;
      const double denom = dcx * dpy - dcy * dpx;
      if (std::fabs(denom) < 1e-12) return false;
      const double n1 = cp1.x * cp2.y - cp1.y * cp2.x;
      const double n2 = s.x * e.y - s.y * e.x;
      const double n3 = 1.0 / denom;
      *out_pt = P2{(n1 * dpx - n2 * dcx) * n3, (n1 * dpy - n2 * dcy) * n3};
      return true;
    };
    P2 s = input.back();
    P2 pt;
    for (const P2& e : input) {
      if (inside(e)) {
        if (!inside(s) && intersect(s, e, &pt)) output.push_back(pt);
        output.push_back(e);
      } else if (inside(s)) {
        if (intersect(s, e, &pt)) output.push_back(pt);
      }
      s = e;
    }
  }
  return output;
}

// Convex-hull area of a small point set (robust to degenerate clips the
// same way the python path uses scipy ConvexHull). Andrew's monotone
// chain.
double hull_area(std::vector<P2> pts) {
  const size_t n = pts.size();
  if (n < 3) return 0.0;
  // sort by (x, y)
  for (size_t i = 0; i < n; ++i)
    for (size_t j = i + 1; j < n; ++j)
      if (pts[j].x < pts[i].x ||
          (pts[j].x == pts[i].x && pts[j].y < pts[i].y))
        std::swap(pts[i], pts[j]);
  auto cross = [](const P2& o, const P2& a, const P2& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
  };
  std::vector<P2> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  const size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0)
      --k;
    hull[k++] = pts[i];
  }
  hull.resize(k > 1 ? k - 1 : 0);
  return poly_area(hull);
}

double box3d_vol(const double* c) {
  auto d = [&](int i, int j) {
    const double dx = c[i * 3] - c[j * 3];
    const double dy = c[i * 3 + 1] - c[j * 3 + 1];
    const double dz = c[i * 3 + 2] - c[j * 3 + 2];
    return std::sqrt(dx * dx + dy * dy + dz * dz);
  };
  return d(0, 1) * d(1, 2) * d(0, 4);
}

std::vector<P2> bev_rect(const double* c) {
  // rows 3..0 of (x, z)
  std::vector<P2> rect(4);
  for (int i = 0; i < 4; ++i)
    rect[i] = P2{c[(3 - i) * 3], c[(3 - i) * 3 + 2]};
  return rect;
}

double one_iou(const double* c1, const double* c2) {
  const std::vector<P2> r1 = bev_rect(c1);
  const std::vector<P2> r2 = bev_rect(c2);
  std::vector<P2> inter = clip_polygon(r1, r2);
  const double inter_area = inter.empty() ? 0.0 : hull_area(inter);
  const double ymax = std::fmin(c1[1], c2[1]);       // top face y
  const double ymin = std::fmax(c1[4 * 3 + 1], c2[4 * 3 + 1]);
  const double inter_vol = inter_area * std::fmax(0.0, ymax - ymin);
  const double v1 = box3d_vol(c1);
  const double v2 = box3d_vol(c2);
  const double denom = v1 + v2 - inter_vol;
  return denom > 1e-12 ? inter_vol / denom : 0.0;
}

}  // namespace

extern "C" {

// corners1: (n, 8, 3), corners2: (m, 8, 3) doubles; out: (n, m).
void box3d_iou_matrix(const double* corners1, int64_t n,
                      const double* corners2, int64_t m, double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = one_iou(corners1 + i * 24, corners2 + j * 24);
}

// Single-pair IoU (parity testing).
double box3d_iou_single(const double* c1, const double* c2) {
  return one_iou(c1, c2);
}
}
