// COLMAP binary model readers (points3D.bin, images.bin): the port's own
// counterpart of the JAX package's native parsers, with the same C ABI.
// Their records have variable length (track lists, image names), so a
// reader walks them in order, here over the file read whole; a Python loop
// takes seconds on a million points.
//
//   colmap_count_points3d(path)                      -> int64 count
//   colmap_read_points3d(path, xyz, rgb, err, cap)   -> int64 written
//   colmap_count_images(path)                        -> int64 count
//   colmap_read_image_poses(path, ids, qvec, tvec, cam_ids, names,
//                           name_cap, cap)           -> int64 written
//
// Every output is a buffer the caller allocated; -1 means the file could
// not be opened or ended inside a record. The plain version is
// data/colmap.py:read_points3d_binary_plain.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// the whole file in memory, read in order: a FILE* with an fseek a record
// would empty its buffer and call the kernel for every point
struct Reader {
    std::vector<char> data;
    size_t pos = 0;
    bool good = false;

    explicit Reader(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (f == nullptr) return;
        if (std::fseek(f, 0, SEEK_END) == 0) {
            const long n = std::ftell(f);
            if (n >= 0 && std::fseek(f, 0, SEEK_SET) == 0) {
                data.resize(static_cast<size_t>(n));
                good = std::fread(data.data(), 1, data.size(), f)
                       == data.size();
            }
        }
        std::fclose(f);
    }
    bool ok() const { return good; }
    template <typename T> bool read(T* out, size_t n = 1) {
        const size_t bytes = sizeof(T) * n;
        if (data.size() - pos < bytes) return false;
        std::memcpy(out, data.data() + pos, bytes);
        pos += bytes;
        return true;
    }
    bool skip(uint64_t n) {
        if (data.size() - pos < n) return false;
        pos += static_cast<size_t>(n);
        return true;
    }
};

int64_t count(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) return -1;
    uint64_t n = 0;
    const bool got = std::fread(&n, sizeof(n), 1, f) == 1;
    std::fclose(f);
    return got ? static_cast<int64_t>(n) : -1;
}

}  // namespace

extern "C" {

int64_t colmap_count_points3d(const char* path) { return count(path); }

// xyz: (cap, 3) f64, rgb: (cap, 3) u8, err: (cap,) f64
int64_t colmap_read_points3d(const char* path, double* xyz, uint8_t* rgb,
                             double* err, int64_t cap) {
    Reader r(path);
    if (!r.ok()) return -1;
    uint64_t n = 0;
    if (!r.read(&n)) return -1;
    const uint64_t n_out = n < static_cast<uint64_t>(cap)
                               ? n : static_cast<uint64_t>(cap);
    for (uint64_t i = 0; i < n_out; ++i) {
        uint64_t id, track_len;
        if (!r.read(&id) || !r.read(xyz + 3 * i, 3) || !r.read(rgb + 3 * i, 3)
            || !r.read(err + i) || !r.read(&track_len)
            || track_len > (uint64_t{1} << 40) || !r.skip(8 * track_len))
            return -1;
    }
    return static_cast<int64_t>(n_out);
}

int64_t colmap_count_images(const char* path) { return count(path); }

// ids: (cap,) i32; qvec: (cap, 4) f64; tvec: (cap, 3) f64; cam_ids: (cap,)
// i32; names: (cap * name_cap,) chars, each NUL-padded
int64_t colmap_read_image_poses(const char* path, int32_t* ids, double* qvec,
                                double* tvec, int32_t* cam_ids, char* names,
                                int64_t name_cap, int64_t cap) {
    Reader r(path);
    if (!r.ok()) return -1;
    uint64_t n = 0;
    if (!r.read(&n)) return -1;
    const uint64_t n_out = n < static_cast<uint64_t>(cap)
                               ? n : static_cast<uint64_t>(cap);
    for (uint64_t i = 0; i < n_out; ++i) {
        if (!r.read(ids + i) || !r.read(qvec + 4 * i, 4)
            || !r.read(tvec + 3 * i, 3) || !r.read(cam_ids + i))
            return -1;
        char* dst = names + i * name_cap;
        std::memset(dst, 0, static_cast<size_t>(name_cap));
        int64_t pos = 0;
        for (;;) {
            char c;
            if (!r.read(&c)) return -1;
            if (c == '\0') break;
            if (pos < name_cap - 1) dst[pos++] = c;
        }
        uint64_t n_pts;
        if (!r.read(&n_pts) || n_pts > (uint64_t{1} << 40)
            || !r.skip(24 * n_pts))
            return -1;
    }
    return static_cast<int64_t>(n_out);
}

}  // extern "C"
