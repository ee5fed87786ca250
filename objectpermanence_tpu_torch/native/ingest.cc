// The port's native ingest: detection pad/align and the containment oracles,
// its own copy of the JAX package's `native/ingest.cc`.
//
// The reference runs these state machines in Python inside
// Dataset.__getitem__ every epoch (baselines/datasets.py:125-416). Here they
// run once at ingest; this C++ implementation keeps large ingests fast. The
// semantics are those of the Python path in data/ingest.py, which gives the
// same arrays bit for bit on float32 boxes (what preprocess and perfect
// perception write) and serves as the parity oracle in the tests.
//
// Built by native/build.py: g++ -O3 -shared -fPIC -std=c++17

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

constexpr int kMaxObjects = 15;
constexpr int kSnitchClass = 140;
constexpr int kSnitchSlot = 0;

inline double center_x(const float* row) { return (row[0] + row[2]) / 2.0; }
inline double center_y(const float* row) { return (row[1] + row[3]) / 2.0; }

int closest_slot(const float* frame, int feature_width, const float* last) {
  const double lx = (last[0] + last[2]) / 2.0;
  const double ly = (last[1] + last[3]) / 2.0;
  int best = 0;
  double best_dist = 1e300;
  for (int o = 0; o < kMaxObjects; ++o) {
    const float* row = frame + o * feature_width;
    const double dx = center_x(row) - lx;
    const double dy = center_y(row) - ly;
    const double dist = std::sqrt(dx * dx + dy * dy);
    if (dist < best_dist) {  // strict <: ties keep the first (np.argmin)
      best_dist = dist;
      best = o;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// boxes: (total_dets, 4) xyxy pixels, labels: (total_dets,), frame_offsets:
// (num_frames + 1,) prefix offsets into the detection arrays. is_cone:
// (num_classes,) 0/1 table. out: (num_frames, 15, feature_width) float32,
// caller-zeroed, filled with NORMALIZED values.
void pad_video(const float* boxes, const int64_t* labels,
               const int64_t* frame_offsets, int num_frames,
               int feature_width, const uint8_t* is_cone, float* out) {
  const double norm[4] = {320.0, 240.0, 320.0, 240.0};

  // canonical slot order: snitch first, then ascending class id
  std::map<int64_t, int> slot_of;
  {
    std::vector<int64_t> ids(labels, labels + frame_offsets[num_frames]);
    std::sort(ids.begin(), ids.end());
    ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
    auto snitch = std::find(ids.begin(), ids.end(), kSnitchClass);
    if (snitch != ids.end()) {
      ids.erase(snitch);
      ids.insert(ids.begin(), kSnitchClass);
    }
    for (size_t i = 0; i < ids.size(); ++i) slot_of[ids[i]] = (int)i;
  }
  const int num_slots = std::min<int>((int)slot_of.size(), kMaxObjects);
  std::vector<uint8_t> cone_slot(kMaxObjects, 0);
  for (const auto& kv : slot_of) {
    if (kv.second < num_slots && is_cone[kv.first]) cone_slot[kv.second] = 1;
  }

  std::vector<uint8_t> seen;
  for (int f = 0; f < num_frames; ++f) {
    float* frame_out = out + (size_t)f * kMaxObjects * feature_width;
    const int64_t begin = frame_offsets[f];
    const int64_t end = frame_offsets[f + 1];
    seen.assign(slot_of.size(), 0);
    int max_slot = -1;
    for (int64_t d = begin; d < end; ++d) {
      const int slot = slot_of.at(labels[d]);
      if (seen[slot]) continue;  // duplicate detection: first wins
      seen[slot] = 1;
      max_slot = std::max(max_slot, slot);
      if (slot >= num_slots) continue;
      float* row = frame_out + slot * feature_width;
      const float* bb = boxes + d * 4;
      for (int k = 0; k < 4; ++k) row[k] = (float)(bb[k] / norm[k]);
      row[4] = 1.0f;
      if (feature_width == 6) row[5] = is_cone[labels[d]] ? 1.0f : 0.0f;
    }
    if (feature_width == 6) {
      // reference quirk: a missing cone keeps its cone bit only for slots
      // before the last detected slot (see data/ingest.py)
      const int limit = std::min(max_slot, num_slots);
      for (int slot = 0; slot < limit; ++slot) {
        float* row = frame_out + slot * feature_width;
        if (cone_slot[slot] && row[4] == 0.0f) row[5] = 1.0f;
      }
    }
  }
}

// padded: (num_frames, 15, feature_width) normalized, out: (num_frames,)
void containment_oracle(const float* padded, int num_frames, int feature_width,
                        int six_track, int32_t* out) {
  std::vector<int> stack;
  std::vector<float> last(feature_width, 0.0f);
  int current = kSnitchSlot;

  for (int f = 0; f < num_frames; ++f) {
    const float* frame = padded + (size_t)f * kMaxObjects * feature_width;
    const float* snitch = frame + kSnitchSlot * feature_width;

    auto set_last = [&](int slot) {
      std::memcpy(last.data(), frame + slot * feature_width,
                  feature_width * sizeof(float));
    };

    if (snitch[4] != 0.0f) {
      out[f] = kSnitchSlot;
      set_last(kSnitchSlot);
      current = kSnitchSlot;
      stack.clear();
    } else if (current == kSnitchSlot) {
      const int closest = closest_slot(frame, feature_width, last.data());
      if (!six_track || frame[closest * feature_width + 5] != 0.0f) {
        out[f] = closest;
        set_last(closest);
        current = closest;
        stack.push_back(kSnitchSlot);
      } else {  // 6-track: non-cone neighbor => occlusion, keep the snitch
        out[f] = kSnitchSlot;
        current = kSnitchSlot;
      }
    } else {
      const float* tracked = frame + current * feature_width;
      if (tracked[4] == 0.0f) {
        const int closest = closest_slot(frame, feature_width, last.data());
        if (!six_track || frame[closest * feature_width + 5] != 0.0f) {
          out[f] = closest;
          set_last(closest);
          stack.push_back(current);
          current = closest;
        } else {
          out[f] = current;  // occlusion: carrier and location unchanged
        }
      } else {
        const int prev = stack.back();
        if (frame[prev * feature_width + 4] != 0.0f) {
          stack.pop_back();
          out[f] = prev;
          set_last(prev);
          current = prev;
        } else {
          out[f] = current;
          set_last(current);
        }
      }
    }
  }
}

}  // extern "C"
