// Host file I/O of the port: the Wavefront OBJ parser and the spectral
// ASCII writer.
//
// A copy of those two sections of the JAX package's native runtime
// (pathtracing_spectrum_tpu/native/src/pts_native.cpp), carried into the
// port because that package's native module cannot be imported without jax.
// The code is unchanged and _build.py compiles it with the same flags, so
// both packages parse each coordinate with the same std::strtof (one
// rounding, decimal straight to float32, where Python's float() followed
// by a float32 cast rounds twice) and format each value with the same
// std::to_chars (general, precision 6: printf's %g in the C locale).
//
// Built with the host compiler (not nvcc) into the port's build/ directory
// at first use and bound with ctypes (utils/obj_loader.py,
// utils/spectral_io.py); plain C ABI.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader: o/g shape splitting, fan triangulation, negative indices,
// per-face smoothing groups, fail-soft on bad lines (utils/obj_loader.py's
// _load_obj_py is its plain version)
// ---------------------------------------------------------------------------

struct ObjShapeData {
  std::string name;
  std::vector<int32_t> v_idx;   // 3 per face
  std::vector<int32_t> vt_idx;
  std::vector<int32_t> vn_idx;
  std::vector<uint32_t> smoothing;  // 1 per face
};

struct ObjHandle {
  std::vector<float> vertices;   // 3 per vertex
  std::vector<float> texcoords;  // 2 per vt
  std::vector<float> normals;    // 3 per vn
  std::vector<ObjShapeData> shapes;
};

static inline int resolve_index(long idx, size_t count) {
  return idx > 0 ? static_cast<int>(idx - 1)
                 : static_cast<int>(static_cast<long>(count) + idx);
}

static inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

ObjHandle* pts_obj_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&data[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  ObjHandle* h = new ObjHandle();
  ObjShapeData cur;
  uint32_t smooth_group = 0;

  struct Corner { int v, t, n; };
  std::vector<Corner> corners;
  corners.reserve(8);

  auto flush = [&]() {
    if (!cur.v_idx.empty()) {
      h->shapes.push_back(std::move(cur));
      cur = ObjShapeData();
      cur.name.clear();
    } else {
      cur.v_idx.clear();
      cur.vt_idx.clear();
      cur.vn_idx.clear();
      cur.smoothing.clear();
    }
  };

  const char* p = data.c_str();
  const char* end = p + data.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p);

    if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      char* e;
      float x = std::strtof(q + 2, &e);
      float y = std::strtof(e, &e);
      float z = std::strtof(e, &e);
      if (e > q + 2) {
        h->vertices.push_back(x);
        h->vertices.push_back(y);
        h->vertices.push_back(z);
      }
    } else if (q[0] == 'v' && q[1] == 't' && (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float u = std::strtof(q + 3, &e);
      float v = std::strtof(e, &e);
      if (e > q + 3) {
        h->texcoords.push_back(u);
        h->texcoords.push_back(v);
      }
    } else if (q[0] == 'v' && q[1] == 'n' && (q[2] == ' ' || q[2] == '\t')) {
      char* e;
      float x = std::strtof(q + 3, &e);
      float y = std::strtof(e, &e);
      float z = std::strtof(e, &e);
      if (e > q + 3) {
        h->normals.push_back(x);
        h->normals.push_back(y);
        h->normals.push_back(z);
      }
    } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      corners.clear();
      const char* c = q + 1;
      bool ok = true;
      while (c < line_end) {
        c = skip_ws(c);
        if (c >= line_end || *c == '\n') break;
        char* e;
        long vi = std::strtol(c, &e, 10);
        if (e == c) { ok = false; break; }
        int v = resolve_index(vi, h->vertices.size() / 3);
        int t = -1, n = -1;
        c = e;
        if (*c == '/') {
          ++c;
          if (*c != '/') {
            long ti = std::strtol(c, &e, 10);
            if (e != c) t = resolve_index(ti, h->texcoords.size() / 2);
            c = e;
          }
          if (*c == '/') {
            ++c;
            long ni = std::strtol(c, &e, 10);
            if (e != c) n = resolve_index(ni, h->normals.size() / 3);
            c = e;
          }
        }
        corners.push_back({v, t, n});
      }
      if (ok && corners.size() >= 3) {
        for (size_t k = 1; k + 1 < corners.size(); ++k) {
          const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
          for (const Corner& cr : tri) {
            cur.v_idx.push_back(cr.v);
            cur.vt_idx.push_back(cr.t);
            cur.vn_idx.push_back(cr.n);
          }
          cur.smoothing.push_back(smooth_group);
        }
      }
    } else if ((q[0] == 'o' || q[0] == 'g') &&
               (q[1] == ' ' || q[1] == '\t' || q + 1 == line_end)) {
      flush();
      const char* name_start = skip_ws(q + 1);
      std::string name(name_start, static_cast<size_t>(line_end - name_start));
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' ' || name.back() == '\t'))
        name.pop_back();
      cur.name = name;
    } else if (q[0] == 's' && (q[1] == ' ' || q[1] == '\t')) {
      const char* val = skip_ws(q + 1);
      if (std::strncmp(val, "off", 3) == 0) {
        smooth_group = 0;
      } else {
        char* e;
        long g = std::strtol(val, &e, 10);
        smooth_group = (e == val) ? 1u : static_cast<uint32_t>(g);
      }
    }
    p = line_end + 1;
  }
  flush();
  return h;
}

void pts_obj_counts(ObjHandle* h, int32_t* n_vertices, int32_t* n_texcoords,
                    int32_t* n_normals, int32_t* n_shapes) {
  *n_vertices = static_cast<int32_t>(h->vertices.size() / 3);
  *n_texcoords = static_cast<int32_t>(h->texcoords.size() / 2);
  *n_normals = static_cast<int32_t>(h->normals.size() / 3);
  *n_shapes = static_cast<int32_t>(h->shapes.size());
}

void pts_obj_copy_attribs(ObjHandle* h, float* vertices, float* texcoords,
                          float* normals) {
  std::memcpy(vertices, h->vertices.data(), h->vertices.size() * sizeof(float));
  std::memcpy(texcoords, h->texcoords.data(),
              h->texcoords.size() * sizeof(float));
  std::memcpy(normals, h->normals.data(), h->normals.size() * sizeof(float));
}

int32_t pts_obj_shape_faces(ObjHandle* h, int32_t shape) {
  return static_cast<int32_t>(h->shapes[shape].smoothing.size());
}

int32_t pts_obj_shape_name(ObjHandle* h, int32_t shape, char* out,
                           int32_t cap) {
  const std::string& s = h->shapes[shape].name;
  int32_t n = static_cast<int32_t>(
      std::min<size_t>(s.size(), static_cast<size_t>(cap - 1)));
  std::memcpy(out, s.data(), static_cast<size_t>(n));
  out[n] = '\0';
  return n;
}

void pts_obj_shape_indices(ObjHandle* h, int32_t shape, int32_t* v_idx,
                           int32_t* vt_idx, int32_t* vn_idx,
                           uint32_t* smoothing) {
  const ObjShapeData& s = h->shapes[shape];
  std::memcpy(v_idx, s.v_idx.data(), s.v_idx.size() * sizeof(int32_t));
  std::memcpy(vt_idx, s.vt_idx.data(), s.vt_idx.size() * sizeof(int32_t));
  std::memcpy(vn_idx, s.vn_idx.data(), s.vn_idx.size() * sizeof(int32_t));
  std::memcpy(smoothing, s.smoothing.data(),
              s.smoothing.size() * sizeof(uint32_t));
}

void pts_obj_free(ObjHandle* h) { delete h; }

// ---------------------------------------------------------------------------
// Spectral ASCII export (reference ExportAt, main.cpp:951-983): for each
// wavelength, h lines of w "%g "-formatted values, NaN -> 0, top row first.
// Byte-identical to utils/spectral_io.format_spectrum. Returns 1 when the
// file cannot be opened, written or closed.
// ---------------------------------------------------------------------------
int32_t pts_export_spectrum(const char* path, const float* img, int32_t h,
                            int32_t w, int32_t nw) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  // std::to_chars(general, 6) is specified to format "as if by printf %g"
  // in the C locale — byte-identical to the Python writer — at a fraction
  // of fprintf's per-call cost (no format parsing, no locale, no lock).
  std::vector<char> line((size_t)w * 16 + 64);
  for (int32_t k = 0; k < nw; ++k) {
    for (int32_t i = 0; i < h; ++i) {
      const float* row = img + ((int64_t)i * w) * nw;
      char* p = line.data();
      for (int32_t j = 0; j < w; ++j) {
        double v = (double)row[(int64_t)j * nw + k];
        if (std::isnan(v)) v = 0.0;
        auto res = std::to_chars(p, line.data() + line.size() - 2, v,
                                 std::chars_format::general, 6);
        p = res.ptr;
        *p++ = ' ';
      }
      *p++ = '\n';
      if (std::fwrite(line.data(), 1, (size_t)(p - line.data()), f)
          != (size_t)(p - line.data())) {
        std::fclose(f);
        return 1;
      }
    }
  }
  return std::fclose(f) ? 1 : 0;
}

}  // extern "C"
