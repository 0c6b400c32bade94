// Native data-runtime: MNIST idx decoding, normalization, host-side
// bitplane packing and the CIFAR-10 binary decode.
//
// Role: the fast host-side IO/preprocessing layer under data/mnist.py and
// data/cifar.py, in the part of the stack that torch's DataLoader
// machinery fills in the reference. The device path stays the PyTorch
// model and its CUDA kernels; this library feeds it. The port's copy of
// the JAX package's native/idx_loader.cpp: the same C ABI and the same
// arithmetic, so its outputs are bitwise that library's.
//
// Exposed via a C ABI for ctypes (no pybind11). All functions return 0
// on success, negative errno-style codes on failure.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Parse an idx header: magic 0x0000080N (u8 data, N dims), big-endian dims.
// dims_out must hold >= 4 entries. Returns ndim, or <0 on error.
int idx_header(const char* path, int64_t* dims_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    unsigned char h[4];
    if (std::fread(h, 1, 4, f) != 4) { std::fclose(f); return -2; }
    if (h[0] != 0 || h[1] != 0 || h[2] != 0x08) { std::fclose(f); return -3; }
    int ndim = h[3];
    if (ndim < 1 || ndim > 4) { std::fclose(f); return -3; }
    for (int i = 0; i < ndim; ++i) {
        unsigned char d[4];
        if (std::fread(d, 1, 4, f) != 4) { std::fclose(f); return -2; }
        dims_out[i] = (int64_t(d[0]) << 24) | (int64_t(d[1]) << 16) |
                      (int64_t(d[2]) << 8) | int64_t(d[3]);
    }
    std::fclose(f);
    return ndim;
}

// Read the u8 payload (after the header) into out[0..n).
int idx_read_u8(const char* path, uint8_t* out, int64_t n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    unsigned char h[4];
    if (std::fread(h, 1, 4, f) != 4) { std::fclose(f); return -2; }
    int ndim = h[3];
    if (std::fseek(f, 4 + 4 * ndim, SEEK_SET) != 0) { std::fclose(f); return -2; }
    size_t got = std::fread(out, 1, (size_t)n, f);
    std::fclose(f);
    return got == (size_t)n ? 0 : -4;
}

// out[i] = (in[i]/255 - mean) / std  — the torchvision Normalize transform.
int u8_normalize(const uint8_t* in, float* out, int64_t n, float mean,
                 float inv_std) {
    const float scale = inv_std / 255.0f;
    const float shift = -mean * inv_std;
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * scale + shift;
    return 0;
}

// Pack ±1 floats into int32 bitplanes along the last axis:
// bit = 1 <=> value > 0; rows x kw output words, zero-padded tail.
// Matches ops/bitpack.py pack_bits_np's convention exactly.
int pack_bits_pm1(const float* in, int32_t* out, int64_t rows, int64_t k,
                  int64_t kw) {
    for (int64_t r = 0; r < rows; ++r) {
        const float* src = in + r * k;
        int32_t* dst = out + r * kw;
        std::memset(dst, 0, (size_t)kw * sizeof(int32_t));
        for (int64_t j = 0; j < k; ++j) {
            if (src[j] > 0.0f)
                dst[j >> 5] |= (int32_t)(1u << (j & 31));
        }
    }
    return 0;
}

// Decode one CIFAR-10 binary batch file: n records of [label u8 |
// 3072 u8 pixels in CHW (plane-major) order]. Writes labels[0..n) and
// images in NHWC order (n*32*32*3) — the transpose the python loader does
// with numpy, fused into the single read pass here.
int cifar_bin_decode(const char* path, uint8_t* images_nhwc,
                     uint8_t* labels, int64_t n_records) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    const int64_t HW = 32 * 32, REC = 1 + 3 * HW;
    unsigned char rec[1 + 3 * 32 * 32];
    for (int64_t r = 0; r < n_records; ++r) {
        if (std::fread(rec, 1, (size_t)REC, f) != (size_t)REC) {
            std::fclose(f);
            return -4;
        }
        labels[r] = rec[0];
        uint8_t* dst = images_nhwc + r * 3 * HW;
        for (int64_t px = 0; px < HW; ++px) {
            dst[px * 3 + 0] = rec[1 + 0 * HW + px];
            dst[px * 3 + 1] = rec[1 + 1 * HW + px];
            dst[px * 3 + 2] = rec[1 + 2 * HW + px];
        }
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
