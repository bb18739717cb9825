// maskops: native mask operations for the host side of evaluation.
//
// This package's own copy of the JAX package's csrc/maskops.cpp, with the
// two kernels the port calls: connected components and the mask IoU
// matrix (its RLE codec runs in numpy, evaluation/rle.py). The reference
// leans on OpenCV's connectedComponents and pycocotools' mask IoU for its
// evaluation loops; this library provides the same primitives through a
// plain C ABI consumed via ctypes (maskunet_tpu_torch/utils/native.py).
// Both functions are thread-safe (no globals) so the Python layer can fan
// evaluation out over a thread pool.
//
// Build (native.py does it at first use):
//   g++ -O3 -shared -fPIC maskops.cpp -o libmaskops.so

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Connected components, 8-connectivity, two-pass union-find.
// mask: row-major uint8 [h*w]; out: int32 labels (0 = background).
// Returns number of labels including background (cv2 convention).
// ---------------------------------------------------------------------------

static inline int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static inline void uf_union(std::vector<int32_t>& parent, int32_t a,
                            int32_t b) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a != b) parent[b < a ? (std::swap(a, b), a) : b] = a;
}

int cc_label(const uint8_t* mask, int h, int w, int32_t* out) {
    std::vector<int32_t> parent(1, 0);
    int32_t next = 1;
    // first pass
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const int i = y * w + x;
            if (!mask[i]) { out[i] = 0; continue; }
            int32_t best = 0;
            int32_t neigh[4];
            int n = 0;
            if (x > 0 && out[i - 1]) neigh[n++] = out[i - 1];
            if (y > 0) {
                const int up = i - w;
                if (out[up]) neigh[n++] = out[up];
                if (x > 0 && out[up - 1]) neigh[n++] = out[up - 1];
                if (x + 1 < w && out[up + 1]) neigh[n++] = out[up + 1];
            }
            for (int k = 0; k < n; ++k)
                if (best == 0 || neigh[k] < best) best = neigh[k];
            if (best == 0) {
                parent.push_back(next);
                out[i] = next++;
            } else {
                out[i] = best;
                for (int k = 0; k < n; ++k) uf_union(parent, best, neigh[k]);
            }
        }
    }
    // flatten + relabel compactly
    std::vector<int32_t> remap(next, 0);
    int32_t compact = 1;
    for (int32_t l = 1; l < next; ++l) {
        int32_t root = uf_find(parent, l);
        if (!remap[root]) remap[root] = compact++;
        remap[l] = remap[root];
    }
    const int total = h * w;
    for (int i = 0; i < total; ++i)
        if (out[i]) out[i] = remap[out[i]];
    return compact;  // labels are 0 .. compact-1
}

// ---------------------------------------------------------------------------
// Pairwise mask IoU (COCOeval semantics): dt [nd, h*w], gt [ng, h*w]
// row-major uint8; iscrowd [ng]; out [nd * ng] double (dt-major).
// Bit-packs masks into uint64 words for popcount intersections.
// ---------------------------------------------------------------------------

void mask_iou(const uint8_t* dt, int nd, const uint8_t* gt, int ng,
              int hw, const uint8_t* iscrowd, double* out) {
    const int words = (hw + 63) / 64;
    std::vector<uint64_t> dtp((size_t)nd * words, 0);
    std::vector<uint64_t> gtp((size_t)ng * words, 0);
    std::vector<long> dta(nd, 0), gta(ng, 0);
    for (int i = 0; i < nd; ++i) {
        const uint8_t* m = dt + (size_t)i * hw;
        uint64_t* p = dtp.data() + (size_t)i * words;
        for (int j = 0; j < hw; ++j)
            if (m[j]) { p[j >> 6] |= 1ull << (j & 63); ++dta[i]; }
    }
    for (int i = 0; i < ng; ++i) {
        const uint8_t* m = gt + (size_t)i * hw;
        uint64_t* p = gtp.data() + (size_t)i * words;
        for (int j = 0; j < hw; ++j)
            if (m[j]) { p[j >> 6] |= 1ull << (j & 63); ++gta[i]; }
    }
    for (int i = 0; i < nd; ++i) {
        const uint64_t* a = dtp.data() + (size_t)i * words;
        for (int j = 0; j < ng; ++j) {
            const uint64_t* b = gtp.data() + (size_t)j * words;
            long inter = 0;
            for (int k = 0; k < words; ++k)
                inter += __builtin_popcountll(a[k] & b[k]);
            const long uni =
                (iscrowd && iscrowd[j]) ? dta[i] : dta[i] + gta[j] - inter;
            out[(size_t)i * ng + j] = uni > 0 ? (double)inter / uni : 0.0;
        }
    }
}

}  // extern "C"
