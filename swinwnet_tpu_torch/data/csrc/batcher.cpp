// Host-side batch assembly for the data feed of the PyTorch port (a copy of
// the JAX package's swinwnet_tpu/native/batcher.cpp: the same source, built
// with the same flags and seeded alike, gives the same stream).
//
// The per-batch host work -- index gather and the noise-injection protocols --
// runs in a C++ worker thread that assembles the NEXT batch while the card
// executes the current step, so the host stays off the step's critical path.
//
// Batches are single-channel [B, H, W]: every consumer computes the
// ensure_2ch Poisson-error channel err = sqrt(|I|) on the device
// (ops/norms.py), so assembling it on the host would only double the
// host-to-device copy.
//
// Noise protocol (one draw of mu per batch): mu ~ U(mu_lo, mu_hi),
// sigma = sigma_frac * mu, additive N(mu, sigma) per pixel. This covers both
//   * the train augmentation  mu ~ U(0, 150), sigma = 0.2 mu
//     (data/noise.py make_train_noise_augment), and
//   * the published eval protocol N(100, 20) via mu_lo = mu_hi = 100,
//     sigma_frac = 0.2.
//
// Exposed as a plain C API consumed via ctypes (data/native_loader.py).
// Build: g++ -O3 -shared -fPIC -std=c++17 batcher.cpp -o libbatcher.so -pthread

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
    std::vector<float> images;  // [B, H, W] (diffraction channel only)
    std::vector<float> masks;   // [B, H, W]
    int64_t n = 0;              // actual samples in this batch
};

struct Loader {
    const float* images = nullptr;  // [N, H, W] source (borrowed)
    const float* masks = nullptr;   // [N, H, W] source or nullptr
    int64_t N = 0, H = 0, W = 0, batch = 0;
    bool shuffle = false;
    bool add_noise = false;
    float mu_lo = 0.0f, mu_hi = 150.0f, sigma_frac = 0.2f;
    uint64_t seed = 0;

    std::vector<int64_t> order;
    int64_t cursor = 0;      // next sample index to schedule
    int64_t epoch = 0;

    // double-buffered prefetch queue
    std::queue<Batch> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::thread worker;
    std::atomic<bool> stop{false};
    size_t max_queue = 2;

    void reshuffle() {
        order.resize(N);
        for (int64_t i = 0; i < N; ++i) order[i] = i;
        if (shuffle) {
            std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
            for (int64_t i = N - 1; i > 0; --i) {
                std::uniform_int_distribution<int64_t> dist(0, i);
                std::swap(order[i], order[dist(rng)]);
            }
        }
    }

    Batch assemble(int64_t start, int64_t count) {
        Batch b;
        b.n = count;
        const int64_t hw = H * W;
        b.images.resize(static_cast<size_t>(batch) * hw, 0.0f);
        b.masks.resize(static_cast<size_t>(batch) * hw, 0.0f);

        std::mt19937_64 rng(seed * 1000003ull + static_cast<uint64_t>(epoch) * 131ull +
                            static_cast<uint64_t>(start));
        // one mu per batch, like make_train_noise_augment
        float bmu = mu_lo;
        if (mu_hi > mu_lo) {
            std::uniform_real_distribution<float> mu_dist(mu_lo, mu_hi);
            bmu = mu_dist(rng);
        }
        std::normal_distribution<float> noise(bmu, sigma_frac * bmu);

        for (int64_t k = 0; k < count; ++k) {
            const int64_t src = order[start + k];
            const float* img = images + src * hw;
            float* dst = b.images.data() + k * hw;
            if (add_noise && bmu > 0.0f) {
                for (int64_t p = 0; p < hw; ++p) dst[p] = img[p] + noise(rng);
            } else {
                std::memcpy(dst, img, sizeof(float) * hw);
            }
            if (masks) {
                std::memcpy(b.masks.data() + k * hw, masks + src * hw,
                            sizeof(float) * hw);
            }
        }
        return b;
    }

    void run() {
        reshuffle();
        while (!stop.load()) {
            int64_t start, count;
            {
                std::unique_lock<std::mutex> lk(mu);
                if (cursor >= N) {
                    ++epoch;
                    cursor = 0;
                    reshuffle();
                }
                start = cursor;
                count = std::min<int64_t>(batch, N - cursor);
                cursor += count;
            }
            Batch b = assemble(start, count);
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
                if (stop.load()) return;
                ready.push(std::move(b));
            }
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* batcher_create(const float* images, const float* masks, int64_t N, int64_t H,
                     int64_t W, int64_t batch, int shuffle, int add_noise,
                     float mu_lo, float mu_hi, float sigma_frac, uint64_t seed) {
    auto* l = new Loader();
    l->images = images;
    l->masks = masks;
    l->N = N;
    l->H = H;
    l->W = W;
    l->batch = batch;
    l->shuffle = shuffle != 0;
    l->add_noise = add_noise != 0;
    l->mu_lo = mu_lo;
    l->mu_hi = mu_hi;
    l->sigma_frac = sigma_frac;
    l->seed = seed;
    l->worker = std::thread([l] { l->run(); });
    return l;
}

// Blocks until the prefetched batch is ready; copies into caller buffers
// (out_images: [batch, H, W]; out_masks: [batch, H, W]). Returns the
// number of real samples in the batch.
int64_t batcher_next(void* handle, float* out_images, float* out_masks) {
    auto* l = static_cast<Loader*>(handle);
    Batch b;
    {
        std::unique_lock<std::mutex> lk(l->mu);
        l->cv_ready.wait(lk, [&] { return !l->ready.empty(); });
        b = std::move(l->ready.front());
        l->ready.pop();
    }
    l->cv_space.notify_one();
    std::memcpy(out_images, b.images.data(), b.images.size() * sizeof(float));
    if (out_masks) std::memcpy(out_masks, b.masks.data(), b.masks.size() * sizeof(float));
    return b.n;
}

void batcher_destroy(void* handle) {
    auto* l = static_cast<Loader*>(handle);
    l->stop.store(true);
    l->cv_space.notify_all();
    if (l->worker.joinable()) l->worker.join();
    delete l;
}

}  // extern "C"
