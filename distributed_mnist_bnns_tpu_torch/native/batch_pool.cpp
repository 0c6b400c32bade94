// Native threaded batch pool: the host-side data-loading runtime (the
// port's copy of the JAX package's native/batch_pool.cpp, the same C ABI).
//
// Role: the part of the reference stack that torch DataLoader's C++
// worker machinery provided (num_workers gather/collate threads feeding
// the train loop; the reference used single-worker defaults,
// mnist-dist2.py:96-108, but the capability lives in torch's native
// layer). Here: N worker threads gather shuffled batches
// (images[idx[b*batch..]] row gathers — the random-access-heavy part of
// the pipeline) into a ring of preallocated slots, ahead of the
// consumer; bp_next blocks until the *in-order* next batch is ready and
// memcpys it into caller-owned memory, so Python-side lifetime is
// trivial and delivery order is deterministic regardless of worker
// scheduling (DistributedSampler-reproducibility semantics).
//
// C ABI for ctypes (no pybind11). Returns: bp_next gives
// the batch ordinal (>=0), BP_DONE when exhausted, negative on error.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kFree = 0;     // slot writable by the worker owning its turn
constexpr int kReady = 1;    // slot filled, waiting for the consumer

struct Slot {
    std::mutex mu;
    std::condition_variable cv;
    int state = kFree;
    int64_t epoch = -1;  // which ring-lap filled it (slot reuse ordering)
    std::vector<float> images;
    std::vector<int32_t> labels;
};

struct BatchPool {
    const float* images;
    const int32_t* labels;
    int64_t feat;
    std::vector<int64_t> idx;  // own a copy: caller's array may be freed
    int64_t n_batches;
    int64_t batch;
    int n_slots;
    std::atomic<int64_t> ticket{0};  // next batch a worker will produce
    int64_t consumed = 0;            // next batch the consumer will take
    std::vector<Slot> slots;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};

    void worker() {
        for (;;) {
            const int64_t b = ticket.fetch_add(1);
            if (b >= n_batches || stop.load()) return;
            Slot& s = slots[b % n_slots];
            const int64_t lap = b / n_slots;
            std::unique_lock<std::mutex> lk(s.mu);
            // Wait for the previous lap's batch in this slot to be
            // consumed (ring backpressure).
            s.cv.wait(lk, [&] {
                return stop.load() || (s.state == kFree && s.epoch == lap - 1);
            });
            if (stop.load()) return;
            lk.unlock();  // gather without holding the lock
            const int64_t* sel = idx.data() + b * batch;
            float* di = s.images.data();
            for (int64_t r = 0; r < batch; ++r)
                std::memcpy(di + r * feat, images + sel[r] * feat,
                            (size_t)feat * sizeof(float));
            int32_t* dl = s.labels.data();
            for (int64_t r = 0; r < batch; ++r) dl[r] = labels[sel[r]];
            lk.lock();
            s.state = kReady;
            s.epoch = lap;
            s.cv.notify_all();
        }
    }
};

}  // namespace

extern "C" {

const int BP_DONE = -1;

// images: (n_items, feat) float32 row-major; labels: (n_items,) int32;
// idx: n_batches*batch gather indices (row order defines the batches).
// The images/labels pointers must stay valid for the pool's lifetime
// (the Python wrapper keeps references); idx is copied.
void* bp_create(const float* images, const int32_t* labels,
                int64_t feat, const int64_t* idx, int64_t n_batches,
                int64_t batch, int n_threads, int n_slots) {
    if (n_batches < 0 || batch <= 0 || feat <= 0 || n_threads <= 0 ||
        n_slots <= 0)
        return nullptr;
    auto* p = new BatchPool();
    p->images = images;
    p->labels = labels;
    p->feat = feat;
    p->idx.assign(idx, idx + n_batches * batch);
    p->n_batches = n_batches;
    p->batch = batch;
    p->n_slots = n_slots;
    p->slots = std::vector<Slot>(n_slots);
    for (auto& s : p->slots) {
        s.images.resize((size_t)(batch * feat));
        s.labels.resize((size_t)batch);
    }
    for (int t = 0; t < n_threads; ++t)
        p->workers.emplace_back([p] { p->worker(); });
    return p;
}

// Blocks until the next in-order batch is ready, copies it into
// out_images (batch*feat floats) / out_labels (batch int32), frees the
// slot. Returns the batch ordinal, or BP_DONE when all batches have been
// delivered.
int64_t bp_next(void* pool, float* out_images, int32_t* out_labels) {
    auto* p = static_cast<BatchPool*>(pool);
    if (p->consumed >= p->n_batches) return BP_DONE;
    const int64_t b = p->consumed++;
    Slot& s = p->slots[b % p->n_slots];
    const int64_t lap = b / p->n_slots;
    std::unique_lock<std::mutex> lk(s.mu);
    s.cv.wait(lk, [&] { return s.state == kReady && s.epoch == lap; });
    std::memcpy(out_images, s.images.data(),
                (size_t)(p->batch * p->feat) * sizeof(float));
    std::memcpy(out_labels, s.labels.data(),
                (size_t)p->batch * sizeof(int32_t));
    s.state = kFree;
    s.cv.notify_all();
    return b;
}

void bp_destroy(void* pool) {
    auto* p = static_cast<BatchPool*>(pool);
    p->stop.store(true);
    for (auto& s : p->slots) {
        std::lock_guard<std::mutex> lk(s.mu);
        s.cv.notify_all();
    }
    for (auto& t : p->workers) t.join();
    delete p;
}

}  // extern "C"
