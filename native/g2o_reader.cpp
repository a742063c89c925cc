// Native host runtime: fast g2o parsing + contiguous block partitioning.
//
// The reference's host-side data pipeline is C++ (DPGO_utils.cpp:8-438);
// this library provides the same role for this framework: a
// zero-dependency C API consumed through ctypes (dpgo_tpu/io/native.py),
// returning flat arrays ready for device upload. The Python parser remains
// as a portable fallback.
//
// Precision conventions match the reference reader exactly:
//   2-D: tau = 2 / tr(TranInfo^-1), kappa = I33    (DPGO_utils.cpp:63-67)
//   3-D: tau = 3 / tr(TranInfo^-1),
//        kappa = 3 / (2 tr(RotInfo^-1))            (DPGO_utils.cpp:107-116)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Edges {
  std::vector<int64_t> i, j;
  std::vector<double> R;      // m * d * d row-major
  std::vector<double> t;      // m * d
  std::vector<double> kappa, tau;
  int d = 0;
  int64_t num_poses = 0;
  std::string error;
};

// Invert a symmetric 2x2 / 3x3 and return the trace of the inverse.
double trace_inv2(const double a[4]) {
  double det = a[0] * a[3] - a[1] * a[2];
  return (a[0] + a[3]) / det;
}

double trace_inv3(const double m[9]) {
  double c00 = m[4] * m[8] - m[5] * m[7];
  double c11 = m[0] * m[8] - m[2] * m[6];
  double c22 = m[0] * m[4] - m[1] * m[3];
  double det = m[0] * c00 - m[1] * (m[3] * m[8] - m[5] * m[6]) +
               m[2] * (m[3] * m[7] - m[4] * m[6]);
  return (c00 + c11 + c22) / det;
}

// Fast float token scanning (strtod loop over whitespace-separated tokens).
bool scan_doubles(const char*& p, const char* end, double* out, int n) {
  for (int k = 0; k < n; ++k) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) return false;
    char* q = nullptr;
    out[k] = std::strtod(p, &q);
    if (q == p) return false;
    p = q;
  }
  return true;
}

Edges* parse(const char* path) {
  auto* E = new Edges();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    E->error = "cannot open file";
    return E;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    E->error = "short read";
    return E;
  }
  std::fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t max_id = -1;

  while (p < end) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    const char* tok = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    size_t tl = static_cast<size_t>(p - tok);

    auto skip_line = [&]() {
      while (p < end && *p != '\n') ++p;
    };

    if (tl == 8 && std::memcmp(tok, "EDGE_SE2", 8) == 0) {
      double v[11];
      if (!scan_doubles(p, end, v, 11)) {
        E->error = "malformed EDGE_SE2";
        return E;
      }
      if (E->d == 0) E->d = 2;
      if (E->d != 2) {
        E->error = "mixed 2-D/3-D measurements";
        return E;
      }
      int64_t i = static_cast<int64_t>(v[0]);
      int64_t j = static_cast<int64_t>(v[1]);
      E->i.push_back(i);
      E->j.push_back(j);
      if (i > max_id) max_id = i;
      if (j > max_id) max_id = j;
      E->t.push_back(v[2]);
      E->t.push_back(v[3]);
      double c = std::cos(v[4]), s = std::sin(v[4]);
      E->R.insert(E->R.end(), {c, -s, s, c});
      double info[4] = {v[5], v[6], v[6], v[8]};
      E->tau.push_back(2.0 / trace_inv2(info));
      E->kappa.push_back(v[10]);
    } else if (tl == 13 && std::memcmp(tok, "EDGE_SE3:QUAT", 13) == 0) {
      double v[30];
      if (!scan_doubles(p, end, v, 30)) {
        E->error = "malformed EDGE_SE3:QUAT";
        return E;
      }
      if (E->d == 0) E->d = 3;
      if (E->d != 3) {
        E->error = "mixed 2-D/3-D measurements";
        return E;
      }
      int64_t i = static_cast<int64_t>(v[0]);
      int64_t j = static_cast<int64_t>(v[1]);
      E->i.push_back(i);
      E->j.push_back(j);
      if (i > max_id) max_id = i;
      if (j > max_id) max_id = j;
      E->t.insert(E->t.end(), {v[2], v[3], v[4]});
      double qx = v[5], qy = v[6], qz = v[7], qw = v[8];
      double nq = std::sqrt(qx * qx + qy * qy + qz * qz + qw * qw);
      qx /= nq; qy /= nq; qz /= nq; qw /= nq;
      double R[9] = {
          1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
          2 * (qx * qz + qy * qw),
          2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qx * qw),
          2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
          1 - 2 * (qx * qx + qy * qy)};
      E->R.insert(E->R.end(), R, R + 9);
      // Information upper triangle order: I11 I12 .. I16 I22 .. I66.
      const double* I = v + 9;
      double T[9] = {I[0], I[1], I[2], I[1], I[6], I[7], I[2], I[7], I[11]};
      double Rot[9] = {I[15], I[16], I[17], I[16], I[18], I[19],
                       I[17], I[19], I[20]};
      E->tau.push_back(3.0 / trace_inv3(T));
      E->kappa.push_back(3.0 / (2.0 * trace_inv3(Rot)));
    } else if (tl >= 6 && std::memcmp(tok, "VERTEX", 6) == 0) {
      skip_line();
    } else {
      E->error = std::string("unrecognized record: ") +
                 std::string(tok, tl);
      return E;
    }
  }
  E->num_poses = max_id + 1;
  return E;
}

}  // namespace

extern "C" {

void* dpgo_parse_g2o(const char* path) { return parse(path); }

const char* dpgo_error(void* h) {
  auto* E = static_cast<Edges*>(h);
  return E->error.empty() ? nullptr : E->error.c_str();
}

int64_t dpgo_num_edges(void* h) {
  return static_cast<int64_t>(static_cast<Edges*>(h)->i.size());
}

int64_t dpgo_num_poses(void* h) { return static_cast<Edges*>(h)->num_poses; }

int dpgo_dim(void* h) { return static_cast<Edges*>(h)->d; }

// Copy out flat arrays (caller allocates).
void dpgo_copy(void* h, int64_t* i, int64_t* j, double* R, double* t,
               double* kappa, double* tau) {
  auto* E = static_cast<Edges*>(h);
  size_t m = E->i.size();
  std::memcpy(i, E->i.data(), m * sizeof(int64_t));
  std::memcpy(j, E->j.data(), m * sizeof(int64_t));
  std::memcpy(R, E->R.data(), E->R.size() * sizeof(double));
  std::memcpy(t, E->t.data(), E->t.size() * sizeof(double));
  std::memcpy(kappa, E->kappa.data(), m * sizeof(double));
  std::memcpy(tau, E->tau.data(), m * sizeof(double));
}

void dpgo_free(void* h) { delete static_cast<Edges*>(h); }

}  // extern "C"
