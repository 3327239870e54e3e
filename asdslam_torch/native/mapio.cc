// Binary `.map` serializer / deserializer (native runtime component).
//
// Writes and reads the exact little-endian layout of the reference's
// hand-rolled serializer (src/visual_map/src/visual_map_seri.cc:56-341,
// save_visual_map / loader_visual_map) — the checkpoint format of the whole
// system (System::saveToVisualMap / LoadORBMap, System.cc:296-439, 38-110).
// Python passes flattened SoA buffers (see asdslam_torch/native/loader.py +
// mapping/persistence.py for the field meanings); this file only moves bytes, so the
// format contract lives in one place and both the C++ and the pure-Python
// paths stay interchangeable.
//
// C API (ctypes):
//   map_save(path, ...SoA buffers...) -> 0 on success
//   map_load_sizes(path, int out[7])  -> 0; out = {n_mp, n_frames, total_kps,
//                desc_width, total_name_bytes, total_imu, n_edges}
//   map_load_fill(path, ...caller-allocated buffers...) -> 0 on success

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Writer {
  FILE* f;
  bool ok = true;
  void put(const void* p, size_t n) {
    if (ok && fwrite(p, 1, n, f) != n) ok = false;
  }
  void i32(int32_t v) { put(&v, 4); }
  void f32(float v) { put(&v, 4); }
  void f64(double v) { put(&v, 8); }
};

struct Reader {
  FILE* f;
  bool ok = true;
  void get(void* p, size_t n) {
    if (ok && fread(p, 1, n, f) != n) ok = false;
  }
  int32_t i32() { int32_t v = 0; get(&v, 4); return v; }
  float f32() { float v = 0; get(&v, 4); return v; }
  double f64() { double v = 0; get(&v, 8); return v; }
  void skip(long n) { if (ok && fseek(f, n, SEEK_CUR) != 0) ok = false; }
};

}  // namespace

extern "C" {

int map_save(const char* path,
             const double* gps_anchor,        // [3]
             const float* tbc_posi,           // [3]
             const float* tbc_quat,           // [4] wxyz
             int n_mp, const float* mp_pos,   // [n_mp*3]
             int n_frames,
             const int* name_lens,            // [F]
             const char* name_bytes,          // concat of all names
             const double* timestamps,        // [F]
             const float* positions,          // [F*3]
             const float* quats,              // [F*4] wxyz
             const float* intrinsics,         // [F*8] fx fy cx cy k1 k2 p1 p2
             const int* wh,                   // [F*2]
             const float* gps_pos,            // [F*3]
             const float* gps_accu,           // [F]
             const int* kp_counts,            // [F]
             const float* kps,                // [sum_kp*2]
             const int* obs_mp,               // [sum_kp]
             const int* octave,               // [sum_kp]
             int desc_width,
             const float* descs,              // [sum_kp*desc_width]
             const int* imu_next,             // [F]
             int n_edges,
             const float* e_posi,             // [E*3]
             const float* e_quat,             // [E*4]
             const float* e_scale,            // [E]
             const float* e_weight,           // [E]
             const int* e_v1, const int* e_v2) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  Writer w{f};
  w.put(gps_anchor, 24);
  w.put(tbc_posi, 12);
  w.put(tbc_quat, 16);
  w.i32(n_mp);
  w.put(mp_pos, (size_t)n_mp * 12);
  w.i32(n_frames);
  const char* nb = name_bytes;
  size_t kp_off = 0;
  for (int i = 0; i < n_frames; ++i) {
    w.i32(name_lens[i]);
    w.put(nb, name_lens[i]);
    nb += name_lens[i];
    w.f64(timestamps[i]);
    w.put(positions + i * 3, 12);
    w.put(quats + i * 4, 16);
    w.put(intrinsics + i * 8, 32);
    w.put(wh + i * 2, 8);
    w.put(gps_pos + i * 3, 12);
    w.f32(gps_accu[i]);
    int nk = kp_counts[i];
    w.i32(nk);
    for (int j = 0; j < nk; ++j) {
      w.put(kps + (kp_off + j) * 2, 8);
      w.i32(obs_mp[kp_off + j]);
      w.i32(octave[kp_off + j]);
    }
    w.i32(desc_width);
    w.i32(nk);
    w.put(descs + kp_off * desc_width, (size_t)nk * desc_width * 4);
    kp_off += nk;
    w.i32(0);  // imu count (SoA export carries no IMU entries)
    w.i32(imu_next[i]);
  }
  w.i32(n_edges);
  for (int i = 0; i < n_edges; ++i) {
    w.put(e_posi + i * 3, 12);
    w.put(e_quat + i * 4, 16);
    w.f32(e_scale[i]);
    w.f32(e_weight[i]);
    w.i32(e_v1[i]);
    w.i32(e_v2[i]);
  }
  int rc = w.ok ? 0 : 2;
  fclose(f);
  return rc;
}

// First pass: walk the file and report allocation sizes.
int map_load_sizes(const char* path, int* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Reader r{f};
  r.skip(24 + 12 + 16);
  int n_mp = r.i32();
  r.skip((long)n_mp * 12);
  int n_frames = r.i32();
  long total_kps = 0, total_names = 0, total_imu = 0;
  int desc_width = 0;
  for (int i = 0; i < n_frames && r.ok; ++i) {
    int nl = r.i32();
    total_names += nl;
    r.skip(nl + 8 + 12 + 16 + 32 + 8 + 12 + 4);
    int nk = r.i32();
    total_kps += nk;
    r.skip((long)nk * 16);
    int dw = r.i32();
    int dc = r.i32();
    if (dc) desc_width = dw;
    r.skip((long)dw * dc * 4);
    int ni = r.i32();
    total_imu += ni;
    r.skip((long)ni * 32 + 4);
  }
  int n_edges = r.i32();
  fclose(f);
  if (!r.ok) return 2;
  out[0] = n_mp;
  out[1] = n_frames;
  out[2] = (int)total_kps;
  out[3] = desc_width;
  out[4] = (int)total_names;
  out[5] = (int)total_imu;
  out[6] = n_edges;
  return 0;
}

// Second pass: fill caller-allocated buffers (sizes from map_load_sizes).
// IMU entries are parsed and returned flattened: [total_imu * 10]
// (acce3, gyro3, ts as two f32 halves is wrong — ts is f64; we return
//  imu_data as [total_imu][8] f32 = acce3+gyro3+pad2 and imu_ts f64).
int map_load_fill(const char* path,
                  double* gps_anchor, float* tbc_posi, float* tbc_quat,
                  float* mp_pos,
                  int* name_lens, char* name_bytes,
                  double* timestamps, float* positions, float* quats,
                  float* intrinsics, int* wh, float* gps_pos, float* gps_accu,
                  int* kp_counts, float* kps, int* obs_mp, int* octave,
                  float* descs,
                  int* imu_counts, float* imu_data, double* imu_ts,
                  int* imu_next,
                  float* e_posi, float* e_quat, float* e_scale,
                  float* e_weight, int* e_v1, int* e_v2) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Reader r{f};
  r.get(gps_anchor, 24);
  r.get(tbc_posi, 12);
  r.get(tbc_quat, 16);
  int n_mp = r.i32();
  r.get(mp_pos, (size_t)n_mp * 12);
  int n_frames = r.i32();
  char* nb = name_bytes;
  size_t kp_off = 0, imu_off = 0;
  for (int i = 0; i < n_frames && r.ok; ++i) {
    int nl = r.i32();
    name_lens[i] = nl;
    r.get(nb, nl);
    nb += nl;
    timestamps[i] = r.f64();
    r.get(positions + i * 3, 12);
    r.get(quats + i * 4, 16);
    r.get(intrinsics + i * 8, 32);
    r.get(wh + i * 2, 8);
    r.get(gps_pos + i * 3, 12);
    gps_accu[i] = r.f32();
    int nk = r.i32();
    kp_counts[i] = nk;
    for (int j = 0; j < nk; ++j) {
      r.get(kps + (kp_off + j) * 2, 8);
      obs_mp[kp_off + j] = r.i32();
      octave[kp_off + j] = r.i32();
    }
    int dw = r.i32();
    int dc = r.i32();
    r.get(descs + kp_off * dw, (size_t)dc * dw * 4);
    kp_off += nk;
    int ni = r.i32();
    imu_counts[i] = ni;
    for (int j = 0; j < ni; ++j) {
      r.get(imu_data + (imu_off + j) * 6, 24);
      imu_ts[imu_off + j] = r.f64();
    }
    imu_off += ni;
    imu_next[i] = r.i32();
  }
  int n_edges = r.i32();
  for (int i = 0; i < n_edges; ++i) {
    r.get(e_posi + i * 3, 12);
    r.get(e_quat + i * 4, 16);
    e_scale[i] = r.f32();
    e_weight[i] = r.f32();
    e_v1[i] = r.i32();
    e_v2[i] = r.i32();
  }
  int rc = r.ok ? 0 : 2;
  fclose(f);
  return rc;
}

}  // extern "C"
