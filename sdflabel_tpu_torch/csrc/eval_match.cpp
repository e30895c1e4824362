// Native evaluator matching kernels.
//
// Behavioral parity target: pipelines/detection_3d.py numba JIT loops —
//   compute_statistics_jit (:1098-1233) and fused_compute_statistics
//   (:1236-1294) — the greedy GT<->detection matching that is inherently
//   sequential per frame. The reference compiles these with numba; here
//   they are C++ (-O3), called via ctypes. Frames are embarrassingly
//   parallel; the python driver shards them (detection_3d.py:411,504).
//
// Conventions (identical to the reference):
//   gt_datas rows:  [bbox(4), rotation_y, alpha]          -> 6 cols
//   dt_datas rows:  [bbox(4), rotation_y, alpha, score]   -> 7 cols
//   overlaps: (num_dt, num_gt) row-major
//   ignored flags: -1 ignore entirely, 0 valid, 1 ignore-but-assignable
//   metric: 0 = 2D bbox (dontcare suppression applies), 1 = BEV, 2 = 3D,
//           3 = nuScenes distance (overlaps hold negative distances)

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kNoDetection = -10000000.0;

double angle_diff(double x, double y, double period) {
  // detection_3d.py:743-758
  double diff = std::fmod(x - y + period / 2.0, period);
  if (diff < 0) diff += period;  // python % is non-negative
  diff -= period / 2.0;
  if (diff > M_PI) diff -= 2.0 * M_PI;
  return diff;
}

// image_box_overlap for dt-vs-dontcare suppression (criterion=0)
void dt_dc_overlap(const double* dt_bboxes, int64_t num_dt,
                   const double* dc_bboxes, int64_t num_dc, double* out) {
  for (int64_t i = 0; i < num_dt; ++i) {
    double area =
        (dt_bboxes[i * 4 + 2] - dt_bboxes[i * 4 + 0]) *
        (dt_bboxes[i * 4 + 3] - dt_bboxes[i * 4 + 1]);
    for (int64_t k = 0; k < num_dc; ++k) {
      double iw = std::min(dt_bboxes[i * 4 + 2], dc_bboxes[k * 4 + 2]) -
                  std::max(dt_bboxes[i * 4 + 0], dc_bboxes[k * 4 + 0]);
      double ih = std::min(dt_bboxes[i * 4 + 3], dc_bboxes[k * 4 + 3]) -
                  std::max(dt_bboxes[i * 4 + 1], dc_bboxes[k * 4 + 1]);
      double v = 0.0;
      if (iw > 0 && ih > 0) v = iw * ih / area;  // criterion 0: / dt area
      out[i * num_dc + k] = v;
    }
  }
}

struct Stats {
  int64_t tp = 0, fp = 0, fn = 0;
  double error_yaw = 0, similarity = 0;
  double match_degree = 0, confidence_error = 0;
  int64_t num_thresholds = 0;
};

// Core greedy matching; thresholds buffer must hold >= num_gt doubles.
Stats compute_statistics(const double* overlaps, const double* gt_datas,
                         const double* dt_datas, const int64_t* ignored_gt,
                         const int64_t* ignored_det, const double* dc_bboxes,
                         int64_t num_gt, int64_t num_dt, int64_t num_dc,
                         int64_t metric, double min_overlap, double thresh,
                         bool compute_fp, bool compute_angular,
                         double* thresholds_out) {
  Stats st;
  std::vector<bool> assigned(num_dt, false);
  std::vector<bool> ignored_threshold(num_dt, false);
  if (compute_fp) {
    for (int64_t i = 0; i < num_dt; ++i)
      if (dt_datas[i * 7 + 6] < thresh) ignored_threshold[i] = true;
  }
  std::vector<double> delta_yaw(num_gt), delta_alpha(num_gt);
  int64_t delta_idx = 0;

  for (int64_t i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = -100000.0;
    bool assigned_ignored_det = false;

    for (int64_t j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1) continue;
      if (assigned[j]) continue;
      if (ignored_threshold[j]) continue;
      double overlap = overlaps[j * num_gt + i];
      double dt_score = dt_datas[j * 7 + 6];
      if (!compute_fp && overlap > min_overlap &&
          dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == kNoDetection && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      st.fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != kNoDetection) {
      st.tp += 1;
      st.match_degree += std::fabs(max_overlap);
      st.confidence_error += -std::log(dt_datas[det_idx * 7 + 6]);
      thresholds_out[st.num_thresholds++] = dt_datas[det_idx * 7 + 6];
      if (compute_angular) {
        delta_yaw[delta_idx] = std::fabs(
            angle_diff(gt_datas[i * 6 + 4], dt_datas[det_idx * 7 + 4],
                       2.0 * M_PI));
        delta_alpha[delta_idx] =
            gt_datas[i * 6 + 5] - dt_datas[det_idx * 7 + 5];
        delta_idx += 1;
      }
      assigned[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (int64_t i = 0; i < num_dt; ++i) {
      if (!(assigned[i] || ignored_det[i] == -1 || ignored_det[i] == 1 ||
            ignored_threshold[i]))
        st.fp += 1;
    }
    int64_t nstuff = 0;
    if (metric == 0 && num_dc > 0) {
      // DontCare suppression (detection_3d.py:1199-1213)
      std::vector<double> dt_bboxes(num_dt * 4);
      for (int64_t j = 0; j < num_dt; ++j)
        for (int64_t c = 0; c < 4; ++c)
          dt_bboxes[j * 4 + c] = dt_datas[j * 7 + c];
      std::vector<double> ov(num_dt * num_dc);
      dt_dc_overlap(dt_bboxes.data(), num_dt, dc_bboxes, num_dc, ov.data());
      for (int64_t i = 0; i < num_dc; ++i) {
        for (int64_t j = 0; j < num_dt; ++j) {
          if (assigned[j]) continue;
          if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
          if (ignored_threshold[j]) continue;
          if (ov[j * num_dc + i] > min_overlap) {
            assigned[j] = true;
            nstuff += 1;
          }
        }
      }
    }
    st.fp -= nstuff;
    if (compute_angular) {
      if (st.tp > 0 || st.fp > 0) {
        double ey = 0, sim = 0;
        for (int64_t i = 0; i < delta_idx; ++i) {
          ey += delta_yaw[i];
          sim += (1.0 + std::cos(delta_alpha[i])) / 2.0;
        }
        st.error_yaw = ey;
        st.similarity = sim;
      } else {
        st.error_yaw = -1;
        st.similarity = -1;
      }
    }
  }
  return st;
}

}  // namespace

extern "C" {

// Single-frame statistics. Returns number of thresholds written.
// out_scalars: [tp, fp, fn, error_yaw, similarity, match_degree,
//               confidence_error]
int64_t sdfl_compute_statistics(
    const double* overlaps, const double* gt_datas, const double* dt_datas,
    const int64_t* ignored_gt, const int64_t* ignored_det,
    const double* dc_bboxes, int64_t num_gt, int64_t num_dt, int64_t num_dc,
    int64_t metric, double min_overlap, double thresh, int64_t compute_fp,
    int64_t compute_angular, double* thresholds_out, double* out_scalars) {
  Stats st = compute_statistics(
      overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
      num_gt, num_dt, num_dc, metric, min_overlap, thresh,
      compute_fp != 0, compute_angular != 0, thresholds_out);
  out_scalars[0] = static_cast<double>(st.tp);
  out_scalars[1] = static_cast<double>(st.fp);
  out_scalars[2] = static_cast<double>(st.fn);
  out_scalars[3] = st.error_yaw;
  out_scalars[4] = st.similarity;
  out_scalars[5] = st.match_degree;
  out_scalars[6] = st.confidence_error;
  return st.num_thresholds;
}

// Fused shard statistics (detection_3d.py:1236-1294).
// overlaps is the shard's stacked (sum_dt, sum_gt) matrix; pr is
// (num_thresholds, 7) accumulated in place.
void sdfl_fused_compute_statistics(
    const double* overlaps, double* pr, const int64_t* gt_nums,
    const int64_t* dt_nums, const int64_t* dc_nums, const double* gt_datas,
    const double* dt_datas, const double* dontcares,
    const int64_t* ignored_gts, const int64_t* ignored_dets,
    int64_t num_samples, int64_t total_gt, int64_t metric,
    double min_overlap, const double* thresholds, int64_t num_thresholds,
    int64_t compute_angular) {
  int64_t gt_num = 0, dt_num = 0, dc_num = 0;
  int64_t gt_stride = 0;
  // overlaps matrix is (total_dt, total_gt) row-major; compute total_gt
  for (int64_t i = 0; i < num_samples; ++i) gt_stride += gt_nums[i];

  std::vector<double> thr_buf;
  for (int64_t i = 0; i < num_samples; ++i) {
    int64_t ng = gt_nums[i], nd = dt_nums[i], nc = dc_nums[i];
    // Slice the frame's overlap block into a dense copy.
    std::vector<double> block(nd * ng);
    for (int64_t j = 0; j < nd; ++j)
      for (int64_t g = 0; g < ng; ++g)
        block[j * ng + g] =
            overlaps[(dt_num + j) * gt_stride + (gt_num + g)];
    thr_buf.resize(std::max<int64_t>(ng, 1));
    for (int64_t t = 0; t < num_thresholds; ++t) {
      Stats st = compute_statistics(
          block.data(), gt_datas + gt_num * 6, dt_datas + dt_num * 7,
          ignored_gts + gt_num, ignored_dets + dt_num, dontcares + dc_num * 4,
          ng, nd, nc, metric, min_overlap, thresholds[t], true,
          compute_angular != 0, thr_buf.data());
      pr[t * 7 + 0] += st.tp;
      pr[t * 7 + 1] += st.fp;
      pr[t * 7 + 2] += st.fn;
      pr[t * 7 + 5] += st.match_degree;
      pr[t * 7 + 6] += st.confidence_error;
      if (st.error_yaw != -1) pr[t * 7 + 3] += st.error_yaw;
      if (st.similarity != -1) pr[t * 7 + 4] += st.similarity;
    }
    gt_num += ng;
    dt_num += nd;
    dc_num += nc;
  }
}

}  // extern "C"
