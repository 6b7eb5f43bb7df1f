// Native IO for gipuma_tpu_torch: binary PLY vertex-buffer assembly + DMB
// codec.  The port's own copy of the JAX package's native/gipuma_io.cpp,
// with the same C entry points.
//
// The reference's host runtime is C++ with an OpenMP-parallel PLY writer
// (displayUtils.h:77-237) and raw-FILE dmb IO (fileIoUtils.h:247-368).
// These are the IO hot paths at scale (hundreds of millions of fused
// points), so they stay native here too; gipuma_tpu_torch/io/native.py
// binds via ctypes with a pure-numpy fallback when the shared library
// cannot be built.
//
// Build: g++ -O3 -shared -fPIC -o libgipuma_io.so gipuma_io.cpp
// (gipuma_tpu_torch/io/native.py builds it on first use into
// gipuma_tpu_torch/build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

extern "C" {

// Write a binary_little_endian PLY with x,y,z,nx,ny,nz,red,green,blue.
// points/normals: [n,3] float32; colors: [n,3] uint8.
// Returns number of vertices written, or -1 on error.
long long gip_write_ply(const char *path, long long n,
                        const float *points, const float *normals,
                        const uint8_t *colors) {
    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;
    char header[512];
    int hl = std::snprintf(
        header, sizeof(header),
        "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n", n);
    if (std::fwrite(header, 1, hl, f) != (size_t)hl) { std::fclose(f); return -1; }

    // Interleave into a chunked buffer: 27 bytes/vertex (6 floats + 3 bytes).
    const long long CHUNK = 1 << 16;
    const size_t stride = 27;
    char *buf = new char[CHUNK * stride];
    for (long long base = 0; base < n; base += CHUNK) {
        long long m = (n - base < CHUNK) ? (n - base) : CHUNK;
        char *p = buf;
        for (long long i = 0; i < m; i++) {
            const long long j = base + i;
            std::memcpy(p, points + 3 * j, 12);  p += 12;
            std::memcpy(p, normals + 3 * j, 12); p += 12;
            std::memcpy(p, colors + 3 * j, 3);   p += 3;
        }
        if (std::fwrite(buf, stride, m, f) != (size_t)m) {
            delete[] buf; std::fclose(f); return -1;
        }
    }
    delete[] buf;
    std::fclose(f);
    return n;
}

// DMB write: int32 header {type=1, h, w, nb} + float32 data.
int gip_write_dmb(const char *path, int32_t h, int32_t w, int32_t nb,
                  const float *data) {
    FILE *f = std::fopen(path, "wb");
    if (!f) return -1;
    int32_t hdr[4] = {1, h, w, nb};
    if (std::fwrite(hdr, 4, 4, f) != 4) { std::fclose(f); return -1; }
    size_t count = (size_t)h * w * nb;
    if (std::fwrite(data, 4, count, f) != count) { std::fclose(f); return -1; }
    std::fclose(f);
    return 0;
}

// DMB header read; returns 0 and fills h/w/nb, or -1.
int gip_read_dmb_header(const char *path, int32_t *h, int32_t *w, int32_t *nb) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    int32_t hdr[4];
    if (std::fread(hdr, 4, 4, f) != 4 || hdr[0] != 1) { std::fclose(f); return -1; }
    *h = hdr[1]; *w = hdr[2]; *nb = hdr[3];
    std::fclose(f);
    return 0;
}

// DMB data read into a caller-allocated buffer of h*w*nb floats.
int gip_read_dmb_data(const char *path, float *out, long long count) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, 16, SEEK_SET) != 0) { std::fclose(f); return -1; }
    if (std::fread(out, 4, count, f) != (size_t)count) { std::fclose(f); return -1; }
    std::fclose(f);
    return 0;
}

}  // extern "C"
