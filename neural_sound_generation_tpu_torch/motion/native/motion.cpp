// Motion-capture runtime: C++ core of the motion-conditioning stack.
//
// The reference vendors the Leap Motion C++ SDK (src/Leap.h: Controller /
// Listener callback model over a Frame -> Hand -> Finger -> Bone scene
// graph) plus a SWIG-generated CPython binding (src/LeapPython.cpp) so a
// Python Listener subclass receives per-frame callbacks from the device
// service thread (SURVEY.md §2 rows 20-22, §3.4).
//
// No physical device exists in a TPU environment, so this library
// re-designs that capability as:
//   * the same scene-graph feature model (hand direction pitch/yaw, palm
//     normal roll, per-finger adjacent-bone joint angles — the 18-feature
//     vector consumed by src/inference.py:100-149),
//   * two frame sources: a CSV *replay* driver (streams recordings in the
//     results/joint_angle_data.csv format at a configurable frame rate)
//     and a *synthetic hand* (full bone-direction scene graph animated by
//     smooth oscillators; joint angles are derived in C++ exactly as the
//     reference derives them from Leap bone directions),
//   * a producer thread with both pull (poll/read) and push (registered
//     callback) delivery — the Controller/Listener model without SWIG:
//     the C ABI below binds to Python via ctypes.
//
// Build: `make` in this directory produces libnsgmotion.so.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kNumFingers = 5;
constexpr int kBonesPerFinger = 4;
constexpr int kNumFeatures = 3 + kNumFingers * (kBonesPerFinger - 1);  // 18

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double x_, double y_, double z_) : x(x_), y(y_), z(z_) {}
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  double norm() const { return std::sqrt(dot(*this)); }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  Vec3 normalized() const {
    double n = norm();
    return n > 1e-12 ? Vec3(x / n, y / n, z / n) : Vec3(0, 0, -1);
  }
  // Leap-convention angles (LeapMath.h semantics): pitch/yaw from a
  // direction vector, roll from the palm normal.
  double pitch() const { return std::atan2(y, -z); }
  double yaw() const { return std::atan2(x, -z); }
  double roll() const { return std::atan2(x, -y); }
};

struct Bone {
  Vec3 direction;  // unit vector from prev_joint to next_joint
};

struct Finger {
  Bone bones[kBonesPerFinger];  // metacarpal, proximal, intermediate, distal
};

struct Hand {
  Vec3 direction;    // palm-to-fingers direction
  Vec3 palm_normal;  // out of the palm
  Finger fingers[kNumFingers];
};

struct Frame {
  int64_t id = 0;
  int64_t timestamp_us = 0;
  bool has_hand = false;
  Hand hand;
  double features[kNumFeatures] = {0};
  // Positional channel for gesture recognition (mm, Leap coordinate
  // conventions: +x right, +y up, -z toward the screen). CSV replay has
  // no positions (recordings store reduced features only, like the
  // reference's results/*.csv), so has_position gates the detector.
  bool has_position = false;
  Vec3 tip_position;    // tracked pointable (index fingertip)
  Vec3 pointable_dir;   // its direction (clockwiseness reference axis)
};

// ---------------------------------------------------------------------------
// Gesture recognition
//
// The reference consumes the Leap SDK's built-in recognizers
// (src/inference.py:170-206: TYPE_CIRCLE with clockwiseness from the
// pointable-direction/circle-normal angle and swept angle from the
// progress delta, TYPE_SWIPE with direction/speed, TYPE_KEY_TAP,
// TYPE_SCREEN_TAP; SDK classes src/Leap.h:1812). No device service
// exists here, so the recognizers themselves are re-implemented: small
// FSMs over the tracked fingertip trajectory. Type/state codes keep the
// Leap numeric conventions so downstream handling reads identically.
// ---------------------------------------------------------------------------

constexpr int kGestureTypeSwipe = 1;      // Leap TYPE_SWIPE
constexpr int kGestureTypeCircle = 4;     // Leap TYPE_CIRCLE
constexpr int kGestureTypeScreenTap = 5;  // Leap TYPE_SCREEN_TAP
constexpr int kGestureTypeKeyTap = 6;     // Leap TYPE_KEY_TAP
constexpr int kGestureStateStart = 1;     // Leap STATE_START
constexpr int kGestureStateUpdate = 2;    // Leap STATE_UPDATE
constexpr int kGestureStateStop = 3;      // Leap STATE_STOP

// Serialized event record: [type, state, id, progress, radius, clockwise,
// speed, dir.x, dir.y, dir.z, pos.x, pos.y, pos.z] — 13 doubles.
constexpr int kGestureDoubles = 13;

struct GestureRecord {
  int type = 0;
  int state = 0;
  int64_t id = 0;
  double progress = 0;  // circle: cumulative turns
  double radius = 0;
  int clockwise = 0;
  double speed = 0;
  Vec3 direction;  // swipe/tap: motion direction; circle: plane normal
  Vec3 position;
  void serialize(double* out) const {
    out[0] = type;
    out[1] = state;
    out[2] = static_cast<double>(id);
    out[3] = progress;
    out[4] = radius;
    out[5] = clockwise;
    out[6] = speed;
    out[7] = direction.x; out[8] = direction.y; out[9] = direction.z;
    out[10] = position.x; out[11] = position.y; out[12] = position.z;
  }
};

class GestureDetector {
 public:
  explicit GestureDetector(double fps) : dt_(1.0 / fps) {
    window_ = std::max<size_t>(8, static_cast<size_t>(fps * 0.8));
  }

  void update(const Frame& f, std::vector<GestureRecord>* out) {
    if (!f.has_position) return;
    const Vec3 p = f.tip_position;
    if (!has_prev_) {
      prev_ = p;
      has_prev_ = true;
      hist_.push_back(p);
      return;
    }
    const Vec3 v = (p - prev_) * (1.0 / dt_);
    prev_ = p;
    hist_.push_back(p);
    if (hist_.size() > window_) hist_.pop_front();

    update_circle(f, p, v, out);
    update_swipe(p, v, out);
    update_tap(key_, v.y, std::hypot(v.x, v.z), kGestureTypeKeyTap, p, v, out);
    update_tap(screen_, v.z, std::hypot(v.x, v.y), kGestureTypeScreenTap, p, v,
               out);
  }

 private:
  // --- circle: accumulated rotation of the radial vector about the mean
  // rotation axis of the recent trajectory window ---------------------------
  void update_circle(const Frame& f, const Vec3& p, const Vec3& v,
                     std::vector<GestureRecord>* out) {
    double total = 0, last_step = 0, mean_r = 0;
    Vec3 normal;
    bool circular = fit_circle(&total, &last_step, &mean_r, &normal);
    const bool moving = v.norm() > 80.0;
    if (!circle_active_) {
      if (circular && std::fabs(total) > 2.0 && moving) {
        circle_active_ = true;
        circle_id_ = next_id_++;
        circle_progress_ = std::fabs(total) / (2 * M_PI);
        circle_normal_ = normal;
        out->push_back(make_circle(f, p, v, kGestureStateStart, mean_r));
      }
      return;
    }
    if (circular && moving) {
      circle_progress_ += std::fabs(last_step) / (2 * M_PI);
      circle_normal_ = normal;
      out->push_back(make_circle(f, p, v, kGestureStateUpdate, mean_r));
    } else {
      out->push_back(make_circle(f, p, v, kGestureStateStop, mean_r));
      circle_active_ = false;
      circle_progress_ = 0;
      hist_.clear();
      hist_.push_back(p);
    }
  }

  GestureRecord make_circle(const Frame& f, const Vec3& p, const Vec3& v,
                            int state, double radius) const {
    GestureRecord g;
    g.type = kGestureTypeCircle;
    g.state = state;
    g.id = circle_id_;
    g.progress = circle_progress_;
    g.radius = radius;
    g.direction = circle_normal_;
    // Leap clockwiseness: pointable direction within 90 deg of the circle
    // normal (src/inference.py:175-178 reads it off angle_to <= pi/2).
    g.clockwise = f.pointable_dir.dot(circle_normal_) >= 0 ? 1 : 0;
    g.speed = v.norm();
    g.position = p;
    return g;
  }

  // Fit the recent window: true if the trajectory sweeps a consistent arc
  // at a roughly constant radius. Outputs the total swept angle over the
  // window, the last per-frame step, the mean radius and the rotation axis.
  bool fit_circle(double* total, double* last_step, double* mean_r,
                  Vec3* normal) const {
    const size_t n = hist_.size();
    if (n < 8) return false;
    Vec3 c;
    for (const Vec3& q : hist_) c = c + q;
    c = c * (1.0 / static_cast<double>(n));
    Vec3 axis_sum;
    double rmin = 1e30, rmax = 0, rsum = 0;
    for (size_t i = 0; i < n; ++i) {
      const Vec3 r = hist_[i] - c;
      const double rn = r.norm();
      rmin = std::min(rmin, rn);
      rmax = std::max(rmax, rn);
      rsum += rn;
      if (i + 1 < n) axis_sum = axis_sum + (hist_[i] - c).cross(hist_[i + 1] - c);
    }
    *mean_r = rsum / static_cast<double>(n);
    if (*mean_r < 15.0 || axis_sum.norm() < 1e-9) return false;
    if (rmax > 2.5 * std::max(rmin, 1.0)) return false;  // not an arc
    const Vec3 nrm = axis_sum.normalized();
    double sum = 0, step = 0;
    for (size_t i = 0; i + 1 < n; ++i) {
      const Vec3 a = hist_[i] - c, b = hist_[i + 1] - c;
      step = std::atan2(a.cross(b).dot(nrm), a.dot(b));
      sum += step;
    }
    *total = sum;
    *last_step = step;
    *normal = nrm;
    return std::fabs(sum) > 0.5;
  }

  // --- swipe: sustained fast straight-line motion --------------------------
  void update_swipe(const Vec3& p, const Vec3& v,
                    std::vector<GestureRecord>* out) {
    const double speed = v.norm();
    if (!swipe_active_) {
      if (speed > 600.0 && !circle_active_) {
        swipe_active_ = true;
        swipe_emitted_ = false;
        swipe_id_ = next_id_++;
        swipe_start_ = p;
        swipe_dir_ = v.normalized();
        swipe_path_len_ = 0;
        swipe_prev_ = p;
      }
      return;
    }
    swipe_path_len_ += (p - swipe_prev_).norm();
    swipe_prev_ = p;
    const Vec3 disp = p - swipe_start_;
    const bool straight =
        swipe_path_len_ < 1e-9 || disp.norm() > 0.93 * swipe_path_len_;
    const bool aligned = v.normalized().dot(swipe_dir_) > 0.7;
    if (speed > 400.0 && straight && aligned) {
      if (!swipe_emitted_ && disp.norm() > 100.0) {
        swipe_emitted_ = true;
        out->push_back(make_swipe(p, v, kGestureStateStart));
      } else if (swipe_emitted_) {
        out->push_back(make_swipe(p, v, kGestureStateUpdate));
      }
    } else {
      if (swipe_emitted_) out->push_back(make_swipe(p, v, kGestureStateStop));
      swipe_active_ = false;
    }
  }

  GestureRecord make_swipe(const Vec3& p, const Vec3& v, int state) const {
    GestureRecord g;
    g.type = kGestureTypeSwipe;
    g.state = state;
    g.id = swipe_id_;
    g.direction = swipe_dir_;
    g.speed = v.norm();
    g.position = p;
    g.progress = (p - swipe_start_).norm();  // displacement so far (mm)
    return g;
  }

  // --- taps: a fast stroke along one axis that reverses within a few
  // frames, with little motion on the other axes. Discrete events (Leap
  // taps report STATE_STOP only). `vel` is the signed axis velocity; taps
  // fire on the negative direction (down for key, forward -z for screen).
  struct TapState {
    int phase = 0;  // 0 idle, 1 in down-stroke
    int frames = 0;
    int cooldown = 0;
    Vec3 start;
  };

  void update_tap(TapState& t, double vel, double lateral_speed, int type,
                  const Vec3& p, const Vec3& v,
                  std::vector<GestureRecord>* out) {
    if (t.cooldown > 0) {
      --t.cooldown;
      return;
    }
    // Gate on an *emitted* swipe, not a tentative one: a tap's fast
    // down-stroke briefly trips the swipe FSM, but a swipe only becomes
    // real after 100 mm of travel — far more than any tap stroke.
    if (circle_active_ || swipe_emitted_) {
      t.phase = 0;
      return;
    }
    if (t.phase == 0) {
      if (vel < -700.0 && std::fabs(vel) > 2.0 * lateral_speed) {
        t.phase = 1;
        t.frames = 0;
        t.start = p;
      }
      return;
    }
    ++t.frames;
    const double stroke = (p - t.start).norm();
    if (vel > -100.0) {  // stroke reversed / stopped: a tap
      if (stroke < 80.0) {
        GestureRecord g;
        g.type = type;
        g.state = kGestureStateStop;
        g.id = next_id_++;
        g.direction = type == kGestureTypeKeyTap ? Vec3(0, -1, 0)
                                                 : Vec3(0, 0, -1);
        g.speed = v.norm();
        g.position = p;
        out->push_back(g);
        t.cooldown = static_cast<int>(0.25 / dt_);
      }
      t.phase = 0;
    } else if (t.frames > 10 || stroke > 80.0) {
      t.phase = 0;  // too long/far: a swipe, not a tap
    }
  }

  double dt_;
  size_t window_;
  std::deque<Vec3> hist_;
  Vec3 prev_;
  bool has_prev_ = false;
  bool circle_active_ = false;
  int64_t circle_id_ = 0;
  double circle_progress_ = 0;
  Vec3 circle_normal_;
  bool swipe_active_ = false;
  bool swipe_emitted_ = false;
  int64_t swipe_id_ = 0;
  Vec3 swipe_start_, swipe_dir_, swipe_prev_;
  double swipe_path_len_ = 0;
  TapState key_, screen_;
  int64_t next_id_ = 1;
};

// Joint-angle feature extraction — the exact computation the reference
// performs per frame in Python (src/inference.py:100-144): [pitch, roll,
// yaw] then, per finger, the dot product of each adjacent bone-direction
// pair ((0,1), (1,2), (2,3)).
void extract_features(const Hand& hand, double out[kNumFeatures]) {
  out[0] = hand.direction.pitch();
  out[1] = hand.palm_normal.roll();
  out[2] = hand.direction.yaw();
  int k = 3;
  for (int f = 0; f < kNumFingers; ++f) {
    for (int b = 1; b < kBonesPerFinger; ++b) {
      out[k++] = hand.fingers[f].bones[b - 1].direction.dot(
          hand.fingers[f].bones[b].direction);
    }
  }
}

// ---------------------------------------------------------------------------
// Frame sources
// ---------------------------------------------------------------------------

class FrameSource {
 public:
  virtual ~FrameSource() = default;
  // Fill `frame` for step `i`; return false when the stream is exhausted.
  virtual bool next(int64_t i, Frame* frame) = 0;
  virtual int64_t length() const { return -1; }  // -1 = unbounded
};

// Replays rows of a joint-angle CSV (18 doubles per line; the checked-in
// recording format results/joint_angle_data.csv). Features are replayed
// verbatim; the scene graph is not reconstructed (a recording stores only
// the reduced features, as in the reference).
class CsvReplaySource : public FrameSource {
 public:
  explicit CsvReplaySource(const char* path, bool loop) : loop_(loop) {
    std::ifstream in(path);
    std::string line;
    while (std::getline(in, line)) {
      if (line.empty()) continue;
      std::vector<double> row;
      std::stringstream ss(line);
      std::string cell;
      while (std::getline(ss, cell, ',')) {
        try {
          row.push_back(std::stod(cell));
        } catch (...) {
          row.clear();
          break;  // header or malformed line: skip
        }
      }
      if (!row.empty()) rows_.push_back(std::move(row));
    }
  }

  bool ok() const { return !rows_.empty(); }
  int64_t length() const override {
    return loop_ ? -1 : static_cast<int64_t>(rows_.size());
  }

  bool next(int64_t i, Frame* frame) override {
    if (rows_.empty()) return false;
    if (!loop_ && i >= static_cast<int64_t>(rows_.size())) return false;
    const auto& row = rows_[static_cast<size_t>(i % rows_.size())];
    frame->has_hand = true;
    int n = static_cast<int>(row.size());
    for (int k = 0; k < kNumFeatures; ++k)
      frame->features[k] = k < n ? row[k] : 0.0;
    return true;
  }

 private:
  std::vector<std::vector<double>> rows_;
  bool loop_;
};

// Synthetic hand: animates a full bone-direction scene graph with smooth
// per-joint oscillators (deterministic per seed), then extracts features
// through the same C++ path a real device frame would take.
class SyntheticHandSource : public FrameSource {
 public:
  SyntheticHandSource(uint64_t seed, int64_t n_frames)
      : seed_(seed), n_frames_(n_frames) {}

  int64_t length() const override { return n_frames_; }

  bool next(int64_t i, Frame* frame) override {
    if (n_frames_ >= 0 && i >= n_frames_) return false;
    double t = static_cast<double>(i) / 60.0;
    Hand& h = frame->hand;
    frame->has_hand = true;

    auto osc = [&](int channel, double lo, double hi, double speed) {
      // deterministic phase from seed+channel (splitmix-style hash)
      uint64_t z = seed_ + 0x9e3779b97f4a7c15ULL * (channel + 1);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      double phase = static_cast<double>((z ^ (z >> 31)) & 0xffff) / 65536.0;
      double s = 0.5 + 0.5 * std::sin(2 * M_PI * (speed * t + phase));
      return lo + (hi - lo) * s;
    };

    // palm orientation sweeps
    double pitch = osc(0, -0.6, 0.6, 0.11);
    double yaw = osc(1, -0.5, 0.5, 0.073);
    double roll = osc(2, -0.8, 0.8, 0.059);
    h.direction =
        Vec3(std::sin(yaw), std::sin(pitch), -std::cos(pitch) * std::cos(yaw))
            .normalized();
    h.palm_normal = Vec3(std::sin(roll), -std::cos(roll), 0).normalized();

    // fingers curl smoothly; each bone bends a little more than the last
    for (int f = 0; f < kNumFingers; ++f) {
      double curl = osc(3 + f, 0.0, 1.2, 0.17 + 0.04 * f);
      double spread = (f - 2) * 0.15;
      double bend = 0.0;
      for (int b = 0; b < kBonesPerFinger; ++b) {
        bend += curl * (0.2 + 0.15 * b);
        h.fingers[f].bones[b].direction =
            Vec3(std::sin(spread), -std::sin(bend), -std::cos(bend)).normalized();
      }
    }
    extract_features(h, frame->features);
    // index fingertip: palm anchor + bone chain at nominal bone lengths
    frame->has_position = true;
    Vec3 tip(0, 200, 0);
    static constexpr double kBoneLen[kBonesPerFinger] = {60, 35, 25, 20};
    for (int b = 0; b < kBonesPerFinger; ++b)
      tip = tip + h.fingers[1].bones[b].direction * kBoneLen[b];
    frame->tip_position = tip;
    frame->pointable_dir = h.fingers[1].bones[kBonesPerFinger - 1].direction;
    return true;
  }

 private:
  uint64_t seed_;
  int64_t n_frames_;
};

// Scripted gesture choreography: a neutral hand whose index fingertip
// performs, in order, a clockwise circle, a counterclockwise circle, a
// rightward swipe, a key tap and a screen tap, separated by rests. The
// deterministic trajectory exercises every recognizer (the synthetic
// stand-in for a human performing the reference's gesture vocabulary,
// src/inference.py:170-206).
class ScriptedGestureSource : public FrameSource {
 public:
  explicit ScriptedGestureSource(double fps) : fps_(fps > 0 ? fps : 60.0) {
    n_frames_ = static_cast<int64_t>(kTotalSeconds * fps_);
  }

  int64_t length() const override { return n_frames_; }

  bool next(int64_t i, Frame* frame) override {
    if (i >= n_frames_) return false;
    const double t = static_cast<double>(i) / fps_;
    Hand& h = frame->hand;
    frame->has_hand = true;
    // static neutral pose; the index finger points at the screen
    h.direction = Vec3(0, 0, -1);
    h.palm_normal = Vec3(0, -1, 0);
    for (int f = 0; f < kNumFingers; ++f)
      for (int b = 0; b < kBonesPerFinger; ++b)
        h.fingers[f].bones[b].direction = Vec3(0, 0, -1);
    extract_features(h, frame->features);
    frame->has_position = true;
    frame->pointable_dir = Vec3(0, 0, -1);
    frame->tip_position = tip_at(t);
    return true;
  }

 private:
  // phase layout (seconds); every phase ends back at the home position so
  // phase boundaries carry no teleport velocity spikes
  static constexpr double kRest0 = 1.0;
  static constexpr double kCircle = 2.0;     // 2 full turns at 1 turn/s
  static constexpr double kGap = 0.7;
  static constexpr double kSwipe = 0.3;      // 270 mm at 900 mm/s
  static constexpr double kSwipeBack = 0.9;  // glide home at 300 mm/s
  static constexpr double kTapDown = 0.05, kTapUp = 0.08;
  static constexpr double kTotalSeconds =
      kRest0 + kCircle + kGap + kCircle + kGap + kSwipe + kSwipeBack + kGap +
      (kTapDown + kTapUp) + kGap + (kTapDown + kTapUp) + kGap;

  Vec3 tip_at(double t) const {
    const Vec3 home(0, 200, 0);
    const double radius = 60.0, turns_per_s = 1.0;
    double s = t - kRest0;
    if (s < 0) return home;
    if (s < kCircle) {  // clockwise on screen: x=r sin, y=r cos, theta up
      const double th = 2 * M_PI * turns_per_s * s;
      return home + Vec3(radius * std::sin(th), radius * std::cos(th) - radius, 0);
    }
    s -= kCircle + kGap;
    if (s < 0) return home;
    if (s < kCircle) {  // counterclockwise: theta decreasing
      const double th = -2 * M_PI * turns_per_s * s;
      return home + Vec3(radius * std::sin(th), radius * std::cos(th) - radius, 0);
    }
    s -= kCircle + kGap;
    if (s < 0) return home;
    if (s < kSwipe) return home + Vec3(900.0 * s, 0, 0);  // swipe right
    if (s < kSwipe + kSwipeBack) {
      const double back = s - kSwipe;
      return home + Vec3(900.0 * kSwipe - 300.0 * back, 0, 0);
    }
    s -= kSwipe + kSwipeBack + kGap;
    if (s < 0) return home;
    if (s < kTapDown) return home + Vec3(0, -1000.0 * s, 0);  // key tap down
    if (s < kTapDown + kTapUp) {
      const double up = s - kTapDown;
      return home + Vec3(0, -1000.0 * kTapDown + 625.0 * up, 0);
    }
    s -= kTapDown + kTapUp + kGap;
    if (s < 0) return home;
    if (s < kTapDown) return home + Vec3(0, 0, -1000.0 * s);  // screen tap
    if (s < kTapDown + kTapUp) {
      const double up = s - kTapDown;
      return home + Vec3(0, 0, -1000.0 * kTapDown + 625.0 * up);
    }
    return home;
  }

  double fps_;
  int64_t n_frames_;
};

// ---------------------------------------------------------------------------
// Controller: producer thread + pull/push delivery
// ---------------------------------------------------------------------------

using FrameCallback = void (*)(const double* features, int n, void* user);
using GestureCallback = void (*)(const double* record, void* user);

class Controller {
 public:
  Controller(FrameSource* source, double fps)
      : source_(source), fps_(fps > 0 ? fps : 60.0), gestures_(fps_) {}

  ~Controller() {
    stop();
    delete source_;
  }

  void set_callback(FrameCallback cb, void* user) {
    std::lock_guard<std::mutex> lock(mu_);
    callback_ = cb;
    callback_user_ = user;
  }

  void start() {
    if (running_.exchange(true)) return;
    // The previous producer may have exited on its own (stream
    // exhausted) leaving thread_ joinable with running_ false:
    // move-assigning a new thread onto a joinable one calls
    // std::terminate and aborts the host process.
    if (thread_.joinable()) thread_.join();
    thread_ = std::thread([this] { run(); });
  }

  void stop() {
    {
      // flip under mu_: read()'s predicate checks running_ under the
      // lock, and a notify between its predicate evaluation and
      // cv_.wait() would otherwise be lost (reader hangs past stop)
      std::lock_guard<std::mutex> lock(mu_);
      running_ = false;
    }
    cv_.notify_all();
    // Always join if joinable: the producer may have exited on its own
    // (stream exhausted) with running_ already false — destroying a
    // joinable std::thread terminates the process.
    if (thread_.joinable()) thread_.join();
  }

  bool running() const { return running_.load(); }

  // Latest frame, non-blocking. Returns frame id or -1 if none yet.
  int64_t poll(double* out, int n) {
    std::lock_guard<std::mutex> lock(mu_);
    if (latest_.id == 0 && !latest_.has_hand) return -1;
    for (int k = 0; k < n && k < kNumFeatures; ++k) out[k] = latest_.features[k];
    return latest_.id;
  }

  // Blocking: wait for a frame newer than `after_id`. Returns id, or -1
  // on stream end / stop.
  int64_t read(int64_t after_id, double* out, int n, double timeout_s) {
    std::unique_lock<std::mutex> lock(mu_);
    auto pred = [&] { return latest_.id > after_id || done_ || !running_; };
    if (timeout_s > 0) {
      if (!cv_.wait_for(lock, std::chrono::duration<double>(timeout_s), pred))
        return -1;
    } else {
      cv_.wait(lock, pred);
    }
    if (latest_.id <= after_id) return -1;
    for (int k = 0; k < n && k < kNumFeatures; ++k) out[k] = latest_.features[k];
    return latest_.id;
  }

  // Synchronous drain (no thread): fetch up to n_frames feature rows.
  // Gesture recognition runs on the drained frames too (logical time at
  // the configured fps), so batch processing sees the same events a
  // realtime stream would.
  int64_t drain(double* out, int64_t n_frames) {
    Frame frame;
    int64_t count = 0;
    while (count < n_frames && source_->next(next_index_++, &frame)) {
      frame.id = next_index_;
      std::memcpy(out + count * kNumFeatures, frame.features,
                  sizeof(double) * kNumFeatures);
      process_gestures(frame);
      ++count;
    }
    return count;
  }

  void set_gesture_callback(GestureCallback cb, void* user) {
    std::lock_guard<std::mutex> lock(mu_);
    gesture_callback_ = cb;
    gesture_callback_user_ = user;
  }

  // Pop up to max_records pending gesture events into out
  // (kGestureDoubles doubles each); returns the count.
  int poll_gestures(double* out, int max_records) {
    std::lock_guard<std::mutex> lock(mu_);
    int n = 0;
    while (n < max_records && !gesture_queue_.empty()) {
      gesture_queue_.front().serialize(out + n * kGestureDoubles);
      gesture_queue_.pop_front();
      ++n;
    }
    return n;
  }

  int64_t source_length() const { return source_->length(); }
  bool done() const { return done_.load(); }

 private:
  void run() {
    const auto period =
        std::chrono::duration<double>(1.0 / fps_);
    Frame frame;
    while (running_) {
      if (!source_->next(next_index_, &frame)) {
        {
          // under mu_ for the same lost-wakeup reason as stop()
          std::lock_guard<std::mutex> lock(mu_);
          done_ = true;
        }
        cv_.notify_all();
        break;
      }
      frame.id = ++next_index_;
      frame.timestamp_us =
          std::chrono::duration_cast<std::chrono::microseconds>(
              std::chrono::steady_clock::now().time_since_epoch())
              .count();
      FrameCallback cb = nullptr;
      void* user = nullptr;
      {
        std::lock_guard<std::mutex> lock(mu_);
        latest_ = frame;
        cb = callback_;
        user = callback_user_;
      }
      cv_.notify_all();
      if (cb) cb(frame.features, kNumFeatures, user);
      process_gestures(frame);
      std::this_thread::sleep_for(period);
    }
    running_ = false;
  }

  // Single-producer (run thread or drain caller, never both: drain
  // requires a stopped controller); queue/callback state is mutex-guarded.
  void process_gestures(const Frame& frame) {
    pending_.clear();
    gestures_.update(frame, &pending_);
    if (pending_.empty()) return;
    GestureCallback cb = nullptr;
    void* user = nullptr;
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (const GestureRecord& g : pending_) {
        gesture_queue_.push_back(g);
        if (gesture_queue_.size() > 4096) gesture_queue_.pop_front();
      }
      cb = gesture_callback_;
      user = gesture_callback_user_;
    }
    if (cb) {
      double rec[kGestureDoubles];
      for (const GestureRecord& g : pending_) {
        g.serialize(rec);
        cb(rec, user);
      }
    }
  }

  FrameSource* source_;
  double fps_;
  std::thread thread_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::atomic<bool> running_{false};
  std::atomic<bool> done_{false};
  Frame latest_;
  int64_t next_index_ = 0;
  FrameCallback callback_ = nullptr;
  void* callback_user_ = nullptr;
  GestureDetector gestures_;
  std::vector<GestureRecord> pending_;
  std::deque<GestureRecord> gesture_queue_;
  GestureCallback gesture_callback_ = nullptr;
  void* gesture_callback_user_ = nullptr;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (ctypes binding surface)
// ---------------------------------------------------------------------------

extern "C" {

int nsg_num_features() { return kNumFeatures; }

void* nsg_replay_controller_new(const char* csv_path, double fps, int loop) {
  auto* src = new CsvReplaySource(csv_path, loop != 0);
  if (!src->ok()) {
    delete src;
    return nullptr;
  }
  return new Controller(src, fps);
}

void* nsg_synthetic_controller_new(uint64_t seed, double fps,
                                   int64_t n_frames) {
  return new Controller(new SyntheticHandSource(seed, n_frames), fps);
}

// Deterministic gesture choreography (circle cw, circle ccw, swipe,
// key tap, screen tap) for driving/validating the recognizers.
void* nsg_scripted_controller_new(double fps) {
  return new Controller(new ScriptedGestureSource(fps), fps);
}

void nsg_controller_free(void* ctrl) { delete static_cast<Controller*>(ctrl); }

void nsg_controller_start(void* ctrl) { static_cast<Controller*>(ctrl)->start(); }

void nsg_controller_stop(void* ctrl) { static_cast<Controller*>(ctrl)->stop(); }

int nsg_controller_running(void* ctrl) {
  return static_cast<Controller*>(ctrl)->running() ? 1 : 0;
}

int nsg_controller_done(void* ctrl) {
  return static_cast<Controller*>(ctrl)->done() ? 1 : 0;
}

int64_t nsg_controller_length(void* ctrl) {
  return static_cast<Controller*>(ctrl)->source_length();
}

int64_t nsg_controller_poll(void* ctrl, double* out, int n) {
  return static_cast<Controller*>(ctrl)->poll(out, n);
}

int64_t nsg_controller_read(void* ctrl, int64_t after_id, double* out, int n,
                            double timeout_s) {
  return static_cast<Controller*>(ctrl)->read(after_id, out, n, timeout_s);
}

int64_t nsg_controller_drain(void* ctrl, double* out, int64_t n_frames) {
  return static_cast<Controller*>(ctrl)->drain(out, n_frames);
}

typedef void (*nsg_frame_callback)(const double*, int, void*);

void nsg_controller_set_callback(void* ctrl, nsg_frame_callback cb,
                                 void* user) {
  static_cast<Controller*>(ctrl)->set_callback(cb, user);
}

// --- gestures --------------------------------------------------------------

int nsg_gesture_record_size() { return kGestureDoubles; }

int nsg_controller_poll_gestures(void* ctrl, double* out, int max_records) {
  return static_cast<Controller*>(ctrl)->poll_gestures(out, max_records);
}

typedef void (*nsg_gesture_callback)(const double*, void*);

void nsg_controller_set_gesture_callback(void* ctrl, nsg_gesture_callback cb,
                                         void* user) {
  static_cast<Controller*>(ctrl)->set_gesture_callback(cb, user);
}

// Record n_frames from a (not-yet-started) controller straight to CSV —
// the MotionDataCollection2csv.py capability (capture joint-angle rows to
// ./results/*.csv, src/MotionDataCollection2csv.py:119-121).
int64_t nsg_record_csv(void* ctrl, const char* path, int64_t n_frames) {
  // validate before allocating: a negative count would wrap huge through
  // static_cast<size_t> and a throwing vector ctor unwinding across the
  // extern "C"/ctypes boundary aborts the host process (std::terminate)
  constexpr int64_t kMaxFrames = int64_t(1) << 30;  // far past any sane run
  if (ctrl == nullptr || path == nullptr || n_frames < 0 ||
      n_frames > kMaxFrames) {
    return -1;
  }
  auto* c = static_cast<Controller*>(ctrl);
  std::vector<double> buf;
  try {
    buf.resize(static_cast<size_t>(n_frames) * kNumFeatures);
  } catch (const std::exception&) {  // bad_alloc on OOM
    return -1;
  }
  int64_t got = c->drain(buf.data(), n_frames);
  std::ofstream out(path);
  if (!out) return -1;
  out.precision(17);  // lossless double -> text roundtrip
  for (int64_t i = 0; i < got; ++i) {
    for (int k = 0; k < kNumFeatures; ++k) {
      out << buf[static_cast<size_t>(i) * kNumFeatures + k];
      if (k + 1 < kNumFeatures) out << ',';
    }
    out << '\n';
  }
  return got;
}

// Extract features from a raw scene-graph dump: [dir(3), normal(3),
// bones(5*4*3)] = 66 doubles. Lets Python-side tests verify the C++
// joint-angle math against an independent implementation.
void nsg_extract_features(const double* scene, double* out) {
  Hand h;
  h.direction = Vec3(scene[0], scene[1], scene[2]);
  h.palm_normal = Vec3(scene[3], scene[4], scene[5]);
  const double* p = scene + 6;
  for (int f = 0; f < kNumFingers; ++f)
    for (int b = 0; b < kBonesPerFinger; ++b) {
      h.fingers[f].bones[b].direction = Vec3(p[0], p[1], p[2]);
      p += 3;
    }
  extract_features(h, out);
}

}  // extern "C"
