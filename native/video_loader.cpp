// Native asynchronous video loader for racing_slam_tpu.
//
// Counterpart of the reference's VideoLoader
// (src/VideoLoader.{h,cpp}, a synchronous cv::VideoCapture wrapper): decode
// runs on a dedicated thread filling a bounded ring buffer of grayscale
// frames, so host-side decode fully overlaps device compute. Exposed with a
// plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (produces librslam_native.so)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct Loader {
    cv::VideoCapture cap;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    size_t queue_cap = 4;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_pop;
    std::condition_variable cv_push;
    std::deque<std::unique_ptr<uint8_t[]>> queue;
    bool eof = false;
    bool closing = false;

    void run() {
        cv::Mat frame, gray;
        for (;;) {
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_push.wait(lk, [&] { return queue.size() < queue_cap || closing; });
                if (closing) return;
            }
            if (!cap.read(frame)) {
                std::lock_guard<std::mutex> lk(mu);
                eof = true;
                cv_pop.notify_all();
                return;
            }
            if (frame.channels() == 3) {
                cv::cvtColor(frame, gray, cv::COLOR_BGR2GRAY);
            } else {
                gray = frame;
            }
            auto buf = std::make_unique<uint8_t[]>(static_cast<size_t>(width) * height);
            if (gray.isContinuous()) {
                std::memcpy(buf.get(), gray.data, static_cast<size_t>(width) * height);
            } else {
                for (int r = 0; r < height; ++r)
                    std::memcpy(buf.get() + static_cast<size_t>(r) * width,
                                gray.ptr(r), width);
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                queue.push_back(std::move(buf));
                cv_pop.notify_one();
            }
        }
    }
};

}  // namespace

extern "C" {

void* vl_open(const char* path, int queue_size) {
    auto* l = new Loader();
    if (!l->cap.open(path)) {
        delete l;
        return nullptr;
    }
    l->width = static_cast<int>(l->cap.get(cv::CAP_PROP_FRAME_WIDTH));
    l->height = static_cast<int>(l->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
    l->fps = l->cap.get(cv::CAP_PROP_FPS);
    l->queue_cap = queue_size > 0 ? static_cast<size_t>(queue_size) : 4;
    l->worker = std::thread([l] { l->run(); });
    return l;
}

void vl_props(void* handle, int* w, int* h, double* fps) {
    auto* l = static_cast<Loader*>(handle);
    *w = l->width;
    *h = l->height;
    *fps = l->fps;
}

// Returns 1 on success (frame written to out, size w*h uint8), 0 at EOF.
int vl_next(void* handle, uint8_t* out) {
    auto* l = static_cast<Loader*>(handle);
    std::unique_ptr<uint8_t[]> buf;
    {
        std::unique_lock<std::mutex> lk(l->mu);
        l->cv_pop.wait(lk, [&] { return !l->queue.empty() || l->eof; });
        if (l->queue.empty()) return 0;
        buf = std::move(l->queue.front());
        l->queue.pop_front();
        l->cv_push.notify_one();
    }
    std::memcpy(out, buf.get(), static_cast<size_t>(l->width) * l->height);
    return 1;
}

void vl_close(void* handle) {
    auto* l = static_cast<Loader*>(handle);
    {
        std::lock_guard<std::mutex> lk(l->mu);
        l->closing = true;
        l->cv_push.notify_all();
    }
    if (l->worker.joinable()) l->worker.join();
    delete l;
}

// Mask loading (reference: cv::imread grayscale, src/main.cpp:33-37).
int vl_load_mask(const char* path, uint8_t* out, int* w, int* h, int max_bytes) {
    cv::Mat m = cv::imread(path, cv::IMREAD_GRAYSCALE);
    if (m.empty()) return 0;
    *w = m.cols;
    *h = m.rows;
    if (m.cols * m.rows > max_bytes) return -1;
    for (int r = 0; r < m.rows; ++r)
        std::memcpy(out + static_cast<size_t>(r) * m.cols, m.ptr(r), m.cols);
    return 1;
}

}  // extern "C"
