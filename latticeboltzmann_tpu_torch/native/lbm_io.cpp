// Native IO runtime for the TPU LBM framework.
//
// The reference writes field snapshots with a per-value fprintf loop
// (PrintLattice, src/latticeboltzmann.c:610-639). At production lattice
// sizes (e.g. 4000x16000) Python-side CSV formatting would dominate the
// snapshot path, so the framework routes it through this small C++
// library (loaded via ctypes, with a pure-NumPy fallback).
//
// Exposed C ABI:
//   lbm_write_csv(path, data, nx, ny)    -> 0 on success
//       one row per lattice row, "%.10f" values, ", "-separated —
//       byte-compatible with the reference's data/<n>.csv layout
//   lbm_write_raw(path, data, n)         -> 0 on success
//       raw little-endian doubles/floats for checkpoint payloads
//   lbm_read_raw(path, data, n)          -> 0 on success

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int lbm_write_csv(const char *path, const double *data, int64_t nx, int64_t ny) {
    FILE *fp = std::fopen(path, "w");
    if (!fp) return -1;
    // ~18 bytes per value; buffer one row at a time
    std::vector<char> buf;
    buf.reserve(static_cast<size_t>(ny) * 20 + 16);
    for (int64_t i = 0; i < nx; i++) {
        buf.clear();
        const double *row = data + i * ny;
        char tmp[48];
        for (int64_t j = 0; j < ny; j++) {
            int n = std::snprintf(tmp, sizeof tmp, j + 1 < ny ? "%.10f, " : "%.10f", row[j]);
            buf.insert(buf.end(), tmp, tmp + n);
        }
        buf.push_back('\n');
        if (std::fwrite(buf.data(), 1, buf.size(), fp) != buf.size()) {
            std::fclose(fp);
            return -2;
        }
    }
    if (std::fclose(fp) != 0) return -3;
    return 0;
}

int lbm_write_raw(const char *path, const void *data, int64_t nbytes) {
    FILE *fp = std::fopen(path, "wb");
    if (!fp) return -1;
    size_t written = std::fwrite(data, 1, static_cast<size_t>(nbytes), fp);
    int rc = std::fclose(fp);
    if (written != static_cast<size_t>(nbytes)) return -2;
    return rc == 0 ? 0 : -3;
}

int lbm_read_raw(const char *path, void *data, int64_t nbytes) {
    FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    size_t got = std::fread(data, 1, static_cast<size_t>(nbytes), fp);
    std::fclose(fp);
    return got == static_cast<size_t>(nbytes) ? 0 : -2;
}

}  // extern "C"
