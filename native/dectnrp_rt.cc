// dectnrp_rt — native host runtime for the TPU-native DECT NR+ framework.
//
// TPU-native equivalents of the reference's C++ concurrency runtime
// (maxpenner/DECT-NR-Plus-SDR):
//   * rb_*   : single-producer / multi-consumer IQ ring buffer where global
//              time IS the 64-bit sample counter and readers block on
//              wait_until_nto (reference lib/include/dectnrp/radio/
//              buffer_rx.hpp:57-139).  The hot producer path is a plain
//              memcpy per antenna with a release-store of the time; readers
//              poll an atomic with a condvar fallback, mirroring the
//              reference's busy-wait / condvar notification selector
//              (buffer_rx.hpp:32-39).
//   * jq_*   : MPMC FIFO job queue with a monotonically increasing fifo_cnt
//              and a `permeable` gate (reference phy/pool/job_queue*.hpp).
//              Jobs are fixed-size POD descriptors; payload stays in Python.
//   * tok_*  : FIFO-ordered token serializing MAC/firmware access: lock(id)
//              and lock_fifo(id, fifo_cnt) admit callers strictly in job
//              order (reference phy/pool/token.hpp:41-87).
//   * dq_*   : fixed-capacity lock-protected datagram queue for the
//              application layer (reference application/queue/queue.hpp).
//
// The compute path (FFT, FEC, correlators) lives on the device in JAX/Pallas;
// this library only carries host-side real-time plumbing: moving IQ between
// an SDR/NIC thread and the batching layer that feeds the device, and
// ordering MAC callbacks. Exposed as a C ABI for ctypes
// (dectnrp_tpu/common/native.py).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#define DECTNRP_HAVE_SOCKETS 1
#endif

#if defined(__unix__) || defined(__APPLE__)
#define DECTNRP_EXPORT extern "C" __attribute__((visibility("default")))
#else
#define DECTNRP_EXPORT extern "C"
#endif

namespace {

// ------------------------------------------------------------- ring buffer

struct RingBuffer {
    int64_t capacity;          // samples per antenna (power of two not required)
    int32_t n_ant;
    std::vector<std::vector<float>> re;  // [ant][capacity]
    std::vector<std::vector<float>> im;
    std::atomic<int64_t> time{0};        // samples written so far == global time
    std::mutex m;
    std::condition_variable cv;
    std::atomic<bool> shutdown{false};

    RingBuffer(int64_t cap, int32_t ants) : capacity(cap), n_ant(ants) {
        re.resize(ants);
        im.resize(ants);
        for (int a = 0; a < ants; ++a) {
            re[a].assign(cap, 0.0f);
            im[a].assign(cap, 0.0f);
        }
    }
};

// ---------------------------------------------------------------- job queue

struct Job {
    int64_t fifo_cnt;
    int32_t type;       // caller-defined (sync/regular/irregular/application)
    int32_t handle;     // caller-defined payload key
    int64_t time64;     // job timestamp (sample count)
};

struct JobQueue {
    int64_t capacity;
    std::deque<Job> q;
    int64_t fifo_cnt = 0;
    bool permeable = true;  // reference job_queue_base.hpp permeable gate
    std::mutex m;
    std::condition_variable cv;
    std::atomic<bool> shutdown{false};

    explicit JobQueue(int64_t cap) : capacity(cap) {}
};

// -------------------------------------------------------------------- token

struct Token {
    std::mutex m;
    std::condition_variable cv;
    bool locked = false;
    int32_t holder = -1;
    int64_t fifo_next = 0;   // next fifo_cnt admitted by lock_fifo
};

// ----------------------------------------------------------- datagram queue

struct DgramQueue {
    size_t capacity_datagrams;
    size_t capacity_bytes;
    std::deque<std::vector<uint8_t>> q;
    size_t bytes = 0;
    int64_t dropped = 0;
    std::mutex m;
    std::condition_variable cv;
    std::atomic<bool> shutdown{false};

    DgramQueue(size_t cap_n, size_t cap_b)
        : capacity_datagrams(cap_n), capacity_bytes(cap_b) {}
};

}  // namespace

// ======================================================== ring buffer C API

DECTNRP_EXPORT void* rb_create(int64_t capacity, int32_t n_ant) {
    if (capacity <= 0 || n_ant <= 0) return nullptr;
    return new (std::nothrow) RingBuffer(capacity, n_ant);
}

DECTNRP_EXPORT void rb_destroy(void* h) { delete static_cast<RingBuffer*>(h); }

DECTNRP_EXPORT int64_t rb_time(void* h) {
    return static_cast<RingBuffer*>(h)->time.load(std::memory_order_acquire);
}

// producer: append n samples per antenna (interleaved per-antenna pointers
// packed contiguously: data[ant*2*n + 2*i] = re, [.. + 2*i + 1] = im).
DECTNRP_EXPORT int rb_write(void* h, const float* data, int64_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    if (n <= 0 || n > rb->capacity) return -1;
    const int64_t t = rb->time.load(std::memory_order_relaxed);
    for (int a = 0; a < rb->n_ant; ++a) {
        const float* src = data + static_cast<size_t>(a) * 2 * n;
        for (int64_t i = 0; i < n; ++i) {
            const int64_t idx = (t + i) % rb->capacity;
            rb->re[a][idx] = src[2 * i];
            rb->im[a][idx] = src[2 * i + 1];
        }
    }
    rb->time.store(t + n, std::memory_order_release);
    {
        std::lock_guard<std::mutex> lk(rb->m);
    }
    rb->cv.notify_all();
    return 0;
}

// reader: copy samples [t0, t0+n) of every antenna into out (same packing as
// rb_write). Fails (-1) if the range is older than capacity allows or in the
// future; use rb_wait_until_nto first for future times.
DECTNRP_EXPORT int rb_read(void* h, float* out, int64_t t0, int64_t n) {
    auto* rb = static_cast<RingBuffer*>(h);
    const int64_t t = rb->time.load(std::memory_order_acquire);
    if (n <= 0 || t0 < 0 || t0 + n > t || t - t0 > rb->capacity) return -1;
    for (int a = 0; a < rb->n_ant; ++a) {
        float* dst = out + static_cast<size_t>(a) * 2 * n;
        for (int64_t i = 0; i < n; ++i) {
            const int64_t idx = (t0 + i) % rb->capacity;
            dst[2 * i] = rb->re[a][idx];
            dst[2 * i + 1] = rb->im[a][idx];
        }
    }
    // re-check the producer didn't lap us mid-copy
    const int64_t t2 = rb->time.load(std::memory_order_acquire);
    if (t2 - t0 > rb->capacity) return -2;
    return 0;
}

// block until ring time >= target (notification-or-timeout; timeout_us < 0
// means wait forever). Returns current ring time, or -1 on shutdown.
DECTNRP_EXPORT int64_t rb_wait_until_nto(void* h, int64_t target,
                                         int64_t timeout_us) {
    auto* rb = static_cast<RingBuffer*>(h);
    std::unique_lock<std::mutex> lk(rb->m);
    auto pred = [&] {
        return rb->shutdown.load(std::memory_order_relaxed) ||
               rb->time.load(std::memory_order_acquire) >= target;
    };
    if (timeout_us < 0) {
        rb->cv.wait(lk, pred);
    } else if (!rb->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                                pred)) {
        return rb->time.load(std::memory_order_acquire);
    }
    if (rb->shutdown.load(std::memory_order_relaxed)) return -1;
    return rb->time.load(std::memory_order_acquire);
}

DECTNRP_EXPORT void rb_shutdown(void* h) {
    auto* rb = static_cast<RingBuffer*>(h);
    rb->shutdown.store(true, std::memory_order_relaxed);
    rb->cv.notify_all();
}

// ========================================================== job queue C API

DECTNRP_EXPORT void* jq_create(int64_t capacity) {
    return new (std::nothrow) JobQueue(capacity > 0 ? capacity : 1024);
}

DECTNRP_EXPORT void jq_destroy(void* h) { delete static_cast<JobQueue*>(h); }

// returns the assigned fifo_cnt, or -1 when full / gate closed.
DECTNRP_EXPORT int64_t jq_enqueue(void* h, int32_t type, int32_t handle,
                                  int64_t time64) {
    auto* jq = static_cast<JobQueue*>(h);
    std::lock_guard<std::mutex> lk(jq->m);
    if (!jq->permeable ||
        static_cast<int64_t>(jq->q.size()) >= jq->capacity)
        return -1;
    const int64_t cnt = jq->fifo_cnt++;
    jq->q.push_back(Job{cnt, type, handle, time64});
    jq->cv.notify_one();
    return cnt;
}

// dequeue one job; blocks up to timeout_us (<0 forever). Returns 0 on
// success (fields written to out[0..3] = fifo_cnt, type, handle, time64),
// -1 on timeout, -2 on shutdown.
DECTNRP_EXPORT int jq_dequeue(void* h, int64_t* out, int64_t timeout_us) {
    auto* jq = static_cast<JobQueue*>(h);
    std::unique_lock<std::mutex> lk(jq->m);
    auto pred = [&] {
        return jq->shutdown.load(std::memory_order_relaxed) || !jq->q.empty();
    };
    if (timeout_us < 0) {
        jq->cv.wait(lk, pred);
    } else if (!jq->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                                pred)) {
        return -1;
    }
    if (jq->q.empty()) return jq->shutdown ? -2 : -1;
    const Job j = jq->q.front();
    jq->q.pop_front();
    out[0] = j.fifo_cnt;
    out[1] = j.type;
    out[2] = j.handle;
    out[3] = j.time64;
    return 0;
}

DECTNRP_EXPORT int64_t jq_size(void* h) {
    auto* jq = static_cast<JobQueue*>(h);
    std::lock_guard<std::mutex> lk(jq->m);
    return static_cast<int64_t>(jq->q.size());
}

DECTNRP_EXPORT void jq_set_permeable(void* h, int32_t permeable) {
    auto* jq = static_cast<JobQueue*>(h);
    std::lock_guard<std::mutex> lk(jq->m);
    jq->permeable = permeable != 0;
}

DECTNRP_EXPORT void jq_shutdown(void* h) {
    auto* jq = static_cast<JobQueue*>(h);
    jq->shutdown.store(true, std::memory_order_relaxed);
    jq->cv.notify_all();
}

// ============================================================== token C API

DECTNRP_EXPORT void* tok_create() { return new (std::nothrow) Token(); }

DECTNRP_EXPORT void tok_destroy(void* h) { delete static_cast<Token*>(h); }

// plain lock (reference token_t::lock(id)); timeout_us < 0 waits forever.
// Returns 1 on acquire, 0 on timeout.
DECTNRP_EXPORT int tok_lock(void* h, int32_t id, int64_t timeout_us) {
    auto* t = static_cast<Token*>(h);
    std::unique_lock<std::mutex> lk(t->m);
    auto pred = [&] { return !t->locked; };
    if (timeout_us < 0) {
        t->cv.wait(lk, pred);
    } else if (!t->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                               pred)) {
        return 0;
    }
    t->locked = true;
    t->holder = id;
    return 1;
}

// FIFO-ordered lock (reference token_t::lock_fifo_to): admitted only when
// fifo_cnt == the next expected count, so tpoint callbacks happen in job
// order even when workers finish out of order.
DECTNRP_EXPORT int tok_lock_fifo(void* h, int32_t id, int64_t fifo_cnt,
                                 int64_t timeout_us) {
    auto* t = static_cast<Token*>(h);
    std::unique_lock<std::mutex> lk(t->m);
    auto pred = [&] { return !t->locked && t->fifo_next == fifo_cnt; };
    if (timeout_us < 0) {
        t->cv.wait(lk, pred);
    } else if (!t->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                               pred)) {
        return 0;
    }
    t->locked = true;
    t->holder = id;
    t->fifo_next = fifo_cnt + 1;
    return 1;
}

DECTNRP_EXPORT void tok_unlock(void* h) {
    auto* t = static_cast<Token*>(h);
    {
        std::lock_guard<std::mutex> lk(t->m);
        t->locked = false;
        t->holder = -1;
    }
    t->cv.notify_all();
}

// ===================================================== datagram queue C API

DECTNRP_EXPORT void* dq_create(int64_t cap_datagrams, int64_t cap_bytes) {
    return new (std::nothrow)
        DgramQueue(static_cast<size_t>(cap_datagrams > 0 ? cap_datagrams : 64),
                   static_cast<size_t>(cap_bytes > 0 ? cap_bytes : 1 << 20));
}

DECTNRP_EXPORT void dq_destroy(void* h) { delete static_cast<DgramQueue*>(h); }

// push one datagram; drop-on-overflow (returns 0 ok, -1 dropped) — the
// reference's fixed-size queue semantics (application/queue/queue.cpp).
DECTNRP_EXPORT int dq_push(void* h, const uint8_t* data, int64_t n) {
    auto* dq = static_cast<DgramQueue*>(h);
    std::lock_guard<std::mutex> lk(dq->m);
    if (dq->q.size() >= dq->capacity_datagrams ||
        dq->bytes + static_cast<size_t>(n) > dq->capacity_bytes) {
        ++dq->dropped;
        return -1;
    }
    dq->q.emplace_back(data, data + n);
    dq->bytes += static_cast<size_t>(n);
    dq->cv.notify_one();
    return 0;
}

// pop one datagram into out (cap out_cap bytes). Returns its length, -1 when
// empty after timeout, -2 on shutdown, -3 when out_cap is too small (the
// datagram stays queued).
DECTNRP_EXPORT int64_t dq_pop(void* h, uint8_t* out, int64_t out_cap,
                              int64_t timeout_us) {
    auto* dq = static_cast<DgramQueue*>(h);
    std::unique_lock<std::mutex> lk(dq->m);
    auto pred = [&] {
        return dq->shutdown.load(std::memory_order_relaxed) || !dq->q.empty();
    };
    if (timeout_us < 0) {
        dq->cv.wait(lk, pred);
    } else if (!dq->cv.wait_for(lk, std::chrono::microseconds(timeout_us),
                                pred)) {
        return -1;
    }
    if (dq->q.empty()) return dq->shutdown ? -2 : -1;
    auto& d = dq->q.front();
    if (static_cast<int64_t>(d.size()) > out_cap) return -3;
    std::memcpy(out, d.data(), d.size());
    const int64_t n = static_cast<int64_t>(d.size());
    dq->bytes -= d.size();
    dq->q.pop_front();
    return n;
}

DECTNRP_EXPORT int64_t dq_size(void* h) {
    auto* dq = static_cast<DgramQueue*>(h);
    std::lock_guard<std::mutex> lk(dq->m);
    return static_cast<int64_t>(dq->q.size());
}

DECTNRP_EXPORT int64_t dq_dropped(void* h) {
    auto* dq = static_cast<DgramQueue*>(h);
    std::lock_guard<std::mutex> lk(dq->m);
    return dq->dropped;
}

DECTNRP_EXPORT void dq_shutdown(void* h) {
    auto* dq = static_cast<DgramQueue*>(h);
    dq->shutdown.store(true, std::memory_order_relaxed);
    dq->cv.notify_all();
}

DECTNRP_EXPORT int32_t dectnrp_rt_abi_version() { return 2; }

// ===================================================== IQ stream producer
//
// File/socket-driven IQ ingress filling an rb_ ring at a paced sample rate:
// the TPU-native analog of the reference's USRP RX streamer thread
// (lib/src/radio/hw_usrp.cpp:1093-1219 recv loop).  Reads chunks of `spp`
// cf32 samples per antenna (packed like rb_write: per antenna, interleaved
// re/im), writes them into the ring, and — when realtime pacing is on —
// sleeps toward an absolute per-chunk deadline derived from rate_hz; chunks
// that fall more than one spp behind schedule are counted as late (the
// producer-side analog of the reference's overflow accounting; it recovers
// by resynchronizing the deadline, like the recv loop recomputing ring time
// from md.time_spec after an overflow).

namespace {

struct IqProducer {
    RingBuffer* rb;
    FILE* f;
    int64_t spp;
    double rate_hz;            // <= 0: free-run (max speed)
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<int64_t> samples{0};
    std::atomic<int64_t> chunks{0};
    std::atomic<int64_t> late_chunks{0};
    std::atomic<int32_t> eof{0};
    std::vector<float> buf;

    void run() {
        using clock = std::chrono::steady_clock;
        const auto chunk_dur =
            rate_hz > 0.0
                ? std::chrono::duration_cast<clock::duration>(
                      std::chrono::duration<double>(
                          static_cast<double>(spp) / rate_hz))
                : clock::duration::zero();
        auto due = clock::now();
        while (!stop.load(std::memory_order_relaxed)) {
            const size_t want = static_cast<size_t>(rb->n_ant) * 2 * spp;
            const size_t got = fread(buf.data(), sizeof(float), want, f);
            if (got < want) {               // EOF or short read: stop cleanly
                eof.store(1, std::memory_order_release);
                break;
            }
            if (rate_hz > 0.0) {
                const auto now = clock::now();
                if (now < due) {
                    std::this_thread::sleep_until(due);
                } else if (now - due > chunk_dur) {
                    // one stall = one late event; rebase the deadline so a
                    // single scheduler hiccup isn't counted against every
                    // subsequent chunk (the recv-loop analog of recomputing
                    // ring time from md.time_spec after an overflow)
                    late_chunks.fetch_add(1, std::memory_order_relaxed);
                    due = now;
                }
                due += chunk_dur;
            }
            rb_write(rb, buf.data(), spp);
            samples.fetch_add(spp, std::memory_order_release);
            chunks.fetch_add(1, std::memory_order_relaxed);
        }
        rb->cv.notify_all();
    }
};

}  // namespace

DECTNRP_EXPORT void* iqp_create_file(void* rb_h, const char* path,
                                     int64_t spp, double rate_hz) {
    auto* rb = static_cast<RingBuffer*>(rb_h);
    if (rb == nullptr || spp <= 0) return nullptr;
    FILE* f = fopen(path, "rb");
    if (f == nullptr) return nullptr;
    auto* p = new (std::nothrow) IqProducer();
    if (p == nullptr) {
        fclose(f);
        return nullptr;
    }
    p->rb = rb;
    p->f = f;
    p->spp = spp;
    p->rate_hz = rate_hz;
    p->buf.assign(static_cast<size_t>(rb->n_ant) * 2 * spp, 0.0f);
    p->th = std::thread([p] { p->run(); });
    return p;
}

DECTNRP_EXPORT int64_t iqp_samples(void* h) {
    return static_cast<IqProducer*>(h)->samples.load(std::memory_order_acquire);
}

DECTNRP_EXPORT int64_t iqp_late_chunks(void* h) {
    return static_cast<IqProducer*>(h)->late_chunks.load(
        std::memory_order_relaxed);
}

DECTNRP_EXPORT int32_t iqp_eof(void* h) {
    return static_cast<IqProducer*>(h)->eof.load(std::memory_order_acquire);
}

DECTNRP_EXPORT void iqp_destroy(void* h) {
    auto* p = static_cast<IqProducer*>(h);
    p->stop.store(true, std::memory_order_relaxed);
    if (p->th.joinable()) p->th.join();
    fclose(p->f);
    delete p;
}

#ifdef DECTNRP_HAVE_SOCKETS

// ================================================== UDP socket IQ producer
//
// Network-fed ingress: the analog of the reference's UHD RX streamer
// receiving IQ from the SDR over 10GbE (lib/src/radio/hw_usrp.cpp:1093-1219
// recv loop). Each UDP datagram carries whole cf32 samples packed like
// rb_write (per antenna, interleaved re/im); arbitrary datagram sizes are
// accepted as long as they hold a whole number of samples. No pacing — the
// sender's own rate IS the clock, exactly like a real NIC-fed radio.

namespace {

struct IqSocketProducer {
    RingBuffer* rb;
    int fd;
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<int64_t> samples{0};
    std::atomic<int64_t> datagrams{0};
    std::atomic<int64_t> malformed{0};  // not a whole number of samples
    std::vector<float> buf;

    void run() {
        const size_t sample_floats = static_cast<size_t>(rb->n_ant) * 2;
        while (!stop.load(std::memory_order_relaxed)) {
            // MSG_TRUNC: got reports the FULL datagram length, so an
            // oversized datagram is detected instead of silently clipped
            // to the buffer (a whole-sample clip would pass the modulo
            // check and desync the stream with no accounting)
            const ssize_t got =
                recv(fd, buf.data(), buf.size() * sizeof(float), MSG_TRUNC);
            if (got < 0) continue;          // timeout: re-check stop
            const size_t nf = static_cast<size_t>(got) / sizeof(float);
            if (nf == 0 || nf % sample_floats != 0 ||
                static_cast<size_t>(got) > buf.size() * sizeof(float)) {
                malformed.fetch_add(1, std::memory_order_relaxed);
                continue;
            }
            const int64_t n = static_cast<int64_t>(nf / sample_floats);
            // datagram layout: per antenna block of n interleaved pairs
            rb_write(rb, buf.data(), n);
            samples.fetch_add(n, std::memory_order_release);
            datagrams.fetch_add(1, std::memory_order_relaxed);
        }
    }
};

}  // namespace

DECTNRP_EXPORT void* iqp_create_socket(void* rb_h, uint16_t port,
                                       int64_t max_samples_per_dgram) {
    auto* rb = static_cast<RingBuffer*>(rb_h);
    if (rb == nullptr || max_samples_per_dgram <= 0) return nullptr;
    const int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(port);
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
        close(fd);
        return nullptr;
    }
    timeval tv{0, 100000};                       // 100 ms stop-poll
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    auto* p = new (std::nothrow) IqSocketProducer();
    if (p == nullptr) {
        close(fd);
        return nullptr;
    }
    p->rb = rb;
    p->fd = fd;
    p->buf.assign(static_cast<size_t>(rb->n_ant) * 2 * max_samples_per_dgram,
                  0.0f);
    p->th = std::thread([p] { p->run(); });
    return p;
}

DECTNRP_EXPORT int64_t iqps_samples(void* h) {
    return static_cast<IqSocketProducer*>(h)->samples.load(
        std::memory_order_acquire);
}

DECTNRP_EXPORT int64_t iqps_datagrams(void* h) {
    return static_cast<IqSocketProducer*>(h)->datagrams.load(
        std::memory_order_relaxed);
}

DECTNRP_EXPORT int64_t iqps_malformed(void* h) {
    return static_cast<IqSocketProducer*>(h)->malformed.load(
        std::memory_order_relaxed);
}

DECTNRP_EXPORT void iqp_destroy_socket(void* h) {
    auto* p = static_cast<IqSocketProducer*>(h);
    p->stop.store(true, std::memory_order_relaxed);
    if (p->th.joinable()) p->th.join();
    close(p->fd);
    delete p;
}

// ====================================================== paced TX consumer
//
// TX egress: drains scheduled bursts into a file or UDP socket at the
// sample rate with strict tx_order_id discipline — the analog of the
// reference's radio TX thread (hw_usrp.cpp:867-877 timed bursts;
// buffer_tx_pool.cpp:69-135 wait_for_specific_tx_order_id). Zeros are
// emitted between bursts (hw_simulator work_tx sends zeros until
// tx_time_64). A burst whose tx_time is already behind the emit cursor
// counts late and its elapsed head is dropped.

namespace {

struct TxBurst {
    int64_t order_id;
    int64_t tx_time;
    std::vector<float> iq;          // [ant][2*n] packed like rb_write
    int64_t n;
};

struct TxConsumer {
    FILE* f = nullptr;              // file sink…
    int fd = -1;                    // …or UDP sink
    sockaddr_in dst{};
    int32_t n_ant;
    int64_t spp;
    double rate_hz;                 // <= 0: free-run
    std::thread th;
    std::atomic<bool> stop{false};
    std::atomic<bool> started{true};         // deferred-start gate
    std::atomic<int64_t> emitted{0};         // samples written
    std::atomic<int64_t> late_bursts{0};
    std::atomic<int64_t> order_violations{0};
    std::atomic<int64_t> send_errors{0};     // failed sendto datagrams
    std::mutex start_m;
    std::condition_variable start_cv;
    int64_t expect_order = 0;
    std::map<int64_t, TxBurst> pending;      // keyed by order_id
    std::deque<TxBurst> active;              // admitted, in order
    std::mutex m;
    std::vector<float> chunk;
    std::vector<float> dgram;                // repack buffer for UDP split

    // UDP datagram payload ceiling (IPv4 65535 - 20 IP - 8 UDP); file sinks
    // write the whole chunk at once.
    static constexpr size_t kUdpPayloadMax = 65507;

    void emit_chunk() {
        if (f != nullptr) {
            fwrite(chunk.data(), sizeof(float), chunk.size(), f);
            return;
        }
        if (fd < 0) return;
        // Split the [ant][spp][2] chunk into datagrams of whole samples in
        // the ingress layout ([ant][n][2] per datagram): one chunk at
        // n_ant=4, spp=2048 is 65536 B > the 65507 B UDP maximum, so an
        // unsplit sendto fails with EMSGSIZE and silently loses the whole
        // TX stream. Mirrors the ingress max_samples_per_dgram bound.
        const size_t bytes_per_sample =
            static_cast<size_t>(n_ant) * 2 * sizeof(float);
        const int64_t max_n = std::max<int64_t>(
            1, static_cast<int64_t>(kUdpPayloadMax / bytes_per_sample));
        for (int64_t s0 = 0; s0 < spp; s0 += max_n) {
            const int64_t n = std::min(max_n, spp - s0);
            const float* src = chunk.data();
            for (int32_t a = 0; a < n_ant; ++a) {
                std::memcpy(dgram.data() + static_cast<size_t>(a) * 2 * n,
                            src + (static_cast<size_t>(a) * spp + s0) * 2,
                            static_cast<size_t>(n) * 2 * sizeof(float));
            }
            const size_t nbytes = static_cast<size_t>(n) * bytes_per_sample;
            if (sendto(fd, dgram.data(), nbytes, 0,
                       reinterpret_cast<const sockaddr*>(&dst),
                       sizeof(dst)) != static_cast<ssize_t>(nbytes)) {
                send_errors.fetch_add(1, std::memory_order_relaxed);
            }
        }
    }

    void run() {
        using clock = std::chrono::steady_clock;
        {
            // deferred start: hold the emit cursor at 0 until txc_start()
            // aligns it with the RX ingress clock (a free-running cursor
            // would lead the RX timebase by the startup gap forever, so
            // every burst scheduled per tx_earliest lands late)
            std::unique_lock<std::mutex> lk(start_m);
            start_cv.wait(lk, [this] {
                return started.load(std::memory_order_acquire) ||
                       stop.load(std::memory_order_relaxed);
            });
        }
        const auto chunk_dur =
            rate_hz > 0.0
                ? std::chrono::duration_cast<clock::duration>(
                      std::chrono::duration<double>(
                          static_cast<double>(spp) / rate_hz))
                : clock::duration::zero();
        auto due = clock::now();
        while (!stop.load(std::memory_order_relaxed)) {
            const int64_t t0 = emitted.load(std::memory_order_relaxed);
            std::fill(chunk.begin(), chunk.end(), 0.0f);
            {
                std::lock_guard<std::mutex> lk(m);
                // admit pending bursts strictly in order-id sequence
                while (true) {
                    auto it = pending.find(expect_order);
                    if (it == pending.end()) break;
                    if (it->second.tx_time < t0)
                        late_bursts.fetch_add(1, std::memory_order_relaxed);
                    active.push_back(std::move(it->second));
                    pending.erase(it);
                    ++expect_order;
                }
                // mix active bursts into [t0, t0+spp)
                for (auto it = active.begin(); it != active.end();) {
                    const int64_t s = std::max(it->tx_time, t0);
                    const int64_t e =
                        std::min(it->tx_time + it->n, t0 + spp);
                    for (int64_t k = s; k < e; ++k) {
                        const int64_t src = k - it->tx_time;
                        const int64_t dstk = k - t0;
                        for (int a = 0; a < n_ant; ++a) {
                            chunk[(a * spp + dstk) * 2] +=
                                it->iq[(a * it->n + src) * 2];
                            chunk[(a * spp + dstk) * 2 + 1] +=
                                it->iq[(a * it->n + src) * 2 + 1];
                        }
                    }
                    if (it->tx_time + it->n <= t0 + spp)
                        it = active.erase(it);      // fully transmitted
                    else
                        ++it;
                }
            }
            // chunk is [ant][spp][2]; emit_chunk repacks per datagram
            if (rate_hz > 0.0) {
                const auto now = clock::now();
                if (now < due) {
                    std::this_thread::sleep_until(due);
                } else if (now - due > chunk_dur) {
                    due = now;                       // resync after a stall
                }
                due += chunk_dur;
            }
            emit_chunk();
            emitted.store(t0 + spp, std::memory_order_release);
        }
        if (f != nullptr) fflush(f);
    }
};

}  // namespace

static TxConsumer* txc_common(int32_t n_ant, int64_t spp, double rate_hz,
                              int32_t deferred) {
    auto* c = new (std::nothrow) TxConsumer();
    if (c == nullptr) return nullptr;
    c->n_ant = n_ant;
    c->spp = spp;
    c->rate_hz = rate_hz;
    c->started.store(deferred == 0, std::memory_order_release);
    c->chunk.assign(static_cast<size_t>(n_ant) * 2 * spp, 0.0f);
    c->dgram.assign(static_cast<size_t>(n_ant) * 2 * spp, 0.0f);
    return c;
}

DECTNRP_EXPORT void* txc_create_file(const char* path, int32_t n_ant,
                                     int64_t spp, double rate_hz,
                                     int32_t deferred) {
    if (n_ant <= 0 || spp <= 0 || rate_hz <= 0.0) return nullptr;
    FILE* f = fopen(path, "wb");
    if (f == nullptr) return nullptr;
    auto* c = txc_common(n_ant, spp, rate_hz, deferred);
    if (c == nullptr) {
        fclose(f);
        return nullptr;
    }
    c->f = f;
    c->th = std::thread([c] { c->run(); });
    return c;
}

DECTNRP_EXPORT void* txc_create_socket(uint16_t port, int32_t n_ant,
                                       int64_t spp, double rate_hz,
                                       int32_t deferred) {
    if (n_ant <= 0 || spp <= 0 || rate_hz <= 0.0) return nullptr;
    const int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return nullptr;
    auto* c = txc_common(n_ant, spp, rate_hz, deferred);
    if (c == nullptr) {
        close(fd);
        return nullptr;
    }
    c->fd = fd;
    c->dst.sin_family = AF_INET;
    c->dst.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    c->dst.sin_port = htons(port);
    c->th = std::thread([c] { c->run(); });
    return c;
}

// Release a deferred-start consumer: the emit cursor (sample 0) starts NOW.
// Called by the radio when the first RX sample lands, so the TX and RX
// timebases share an origin (they always shared a rate).
DECTNRP_EXPORT void txc_start(void* h) {
    auto* c = static_cast<TxConsumer*>(h);
    {
        std::lock_guard<std::mutex> lk(c->start_m);
        c->started.store(true, std::memory_order_release);
    }
    c->start_cv.notify_all();
}

DECTNRP_EXPORT int64_t txc_send_errors(void* h) {
    return static_cast<TxConsumer*>(h)->send_errors.load(
        std::memory_order_relaxed);
}

// schedule a burst (data packed like rb_write: [ant][n][2] floats).
// Returns 0, or -1 on a violated order id (already admitted past it).
DECTNRP_EXPORT int txc_schedule(void* h, int64_t order_id, int64_t tx_time,
                                const float* data, int64_t n) {
    auto* c = static_cast<TxConsumer*>(h);
    std::lock_guard<std::mutex> lk(c->m);
    if (order_id < c->expect_order) {
        c->order_violations.fetch_add(1, std::memory_order_relaxed);
        return -1;
    }
    TxBurst b;
    b.order_id = order_id;
    b.tx_time = tx_time;
    b.n = n;
    b.iq.assign(data, data + static_cast<size_t>(c->n_ant) * 2 * n);
    if (!c->pending.emplace(order_id, std::move(b)).second) {
        // duplicate order id still pending: reject loudly, do not drop
        c->order_violations.fetch_add(1, std::memory_order_relaxed);
        return -1;
    }
    return 0;
}

DECTNRP_EXPORT int64_t txc_emitted(void* h) {
    return static_cast<TxConsumer*>(h)->emitted.load(std::memory_order_acquire);
}

DECTNRP_EXPORT int64_t txc_late(void* h) {
    return static_cast<TxConsumer*>(h)->late_bursts.load(
        std::memory_order_relaxed);
}

DECTNRP_EXPORT int64_t txc_order_violations(void* h) {
    return static_cast<TxConsumer*>(h)->order_violations.load(
        std::memory_order_relaxed);
}

DECTNRP_EXPORT void txc_destroy(void* h) {
    auto* c = static_cast<TxConsumer*>(h);
    c->stop.store(true, std::memory_order_relaxed);
    c->start_cv.notify_all();       // release a deferred, never-started run()
    if (c->th.joinable()) c->th.join();
    if (c->f != nullptr) fclose(c->f);
    if (c->fd >= 0) close(c->fd);
    delete c;
}

#endif  // DECTNRP_HAVE_SOCKETS
