// broker_core — native per-endpoint message queue engine; a copy of the JAX
// package's native/broker_core.cpp.
//
// A C++ queue engine with the same contract as the Python broker
// (ai4e_tpu_torch/broker/queue.py: publish / lease-receive / complete /
// abandon / dead-letter), exposed through a C ABI consumed from Python via
// ctypes (ai4e_tpu_torch/broker/native.py). No GIL on the hot path:
// blocking receives park on a condition variable, publishes come from any
// thread.
//
// Built on first use by ai4e_tpu_torch/utils/native_build.py:
// g++ -O2 -shared -fPIC -std=c++17 broker_core.cpp -o libbroker_core.so

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Message {
  uint64_t seq = 0;
  std::string task_id;
  std::string endpoint;
  std::string content_type;
  std::vector<uint8_t> body;
  uint32_t delivery_count = 0;
  double lease_expires = 0.0;  // epoch seconds
};

double now_seconds() {
  return static_cast<double>(
             std::chrono::duration_cast<std::chrono::microseconds>(
                 std::chrono::system_clock::now().time_since_epoch())
                 .count()) /
         1e6;
}

class EndpointQueue {
 public:
  EndpointQueue(uint32_t max_delivery, double lease_seconds)
      : max_delivery_(max_delivery), lease_seconds_(lease_seconds) {}

  void put(std::shared_ptr<Message> msg) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      ready_.push_back(std::move(msg));
    }
    cv_.notify_one();
  }

  // Lease the next message; nullptr on timeout. timeout_ms < 0 → wait forever.
  std::shared_ptr<Message> receive(int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    auto ready_pred = [this] {
      reap_expired_locked();
      return !ready_.empty() || closed_;
    };
    if (timeout_ms < 0) {
      // Bounded waits so the reaper keeps running even with no traffic.
      while (!ready_pred())
        cv_.wait_for(lk, std::chrono::milliseconds(50));
    } else {
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::milliseconds(timeout_ms);
      while (!ready_pred()) {
        if (cv_.wait_until(lk, std::min(deadline,
                                        std::chrono::steady_clock::now() +
                                            std::chrono::milliseconds(50))) ==
                std::cv_status::timeout &&
            std::chrono::steady_clock::now() >= deadline) {
          if (!ready_pred()) return nullptr;
          break;
        }
      }
    }
    if (ready_.empty()) return nullptr;
    auto msg = ready_.front();
    ready_.pop_front();
    msg->delivery_count += 1;
    msg->lease_expires = now_seconds() + lease_seconds_;
    leased_[msg->seq] = msg;
    return msg;
  }

  void complete(uint64_t seq) {
    std::lock_guard<std::mutex> lk(mu_);
    if (leased_.erase(seq) == 0) {
      // Lease expired, reaper requeued: retract so a finished message is
      // not delivered again.
      for (auto it = ready_.begin(); it != ready_.end(); ++it) {
        if ((*it)->seq == seq) {
          ready_.erase(it);
          break;
        }
      }
    }
  }

  // Returns: 1 requeued, 0 dead-lettered, 2 no-op (lease already reaped).
  int abandon(uint64_t seq) {
    std::shared_ptr<Message> msg;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = leased_.find(seq);
      if (it == leased_.end()) {
        for (const auto& d : dead_) {
          if (d->seq == seq) return 0;
        }
        return 2;
      }
      msg = it->second;
      leased_.erase(it);
      if (msg->delivery_count >= max_delivery_) {
        dead_.push_back(msg);
        return 0;
      }
      ready_.push_back(msg);
    }
    cv_.notify_one();
    return 1;
  }

  std::shared_ptr<Message> pop_dead_letter() {
    std::lock_guard<std::mutex> lk(mu_);
    if (dead_.empty()) return nullptr;
    auto msg = dead_.front();
    dead_.pop_front();
    return msg;
  }

  size_t depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return ready_.size();
  }

  size_t in_flight() {
    std::lock_guard<std::mutex> lk(mu_);
    return leased_.size();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      closed_ = true;
    }
    cv_.notify_all();
  }

 private:
  void reap_expired_locked() {
    const double now = now_seconds();
    for (auto it = leased_.begin(); it != leased_.end();) {
      if (it->second->lease_expires <= now) {
        auto msg = it->second;
        it = leased_.erase(it);
        if (msg->delivery_count >= max_delivery_) {
          dead_.push_back(msg);
        } else {
          ready_.push_back(msg);
        }
      } else {
        ++it;
      }
    }
  }

  const uint32_t max_delivery_;
  const double lease_seconds_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::shared_ptr<Message>> ready_;
  std::unordered_map<uint64_t, std::shared_ptr<Message>> leased_;
  std::deque<std::shared_ptr<Message>> dead_;
  bool closed_ = false;
};

class Broker {
 public:
  Broker(uint32_t max_delivery, double lease_seconds)
      : max_delivery_(max_delivery), lease_seconds_(lease_seconds) {}

  EndpointQueue* queue(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = queues_.find(name);
    if (it == queues_.end()) {
      it = queues_
               .emplace(name, std::make_unique<EndpointQueue>(max_delivery_,
                                                              lease_seconds_))
               .first;
    }
    return it->second.get();
  }

  // Longest registered-queue prefix match (broker/queue.py semantics).
  std::string resolve(const std::string& path) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string best;
    for (const auto& [name, _] : queues_) {
      if (path == name ||
          (path.size() > name.size() && path.compare(0, name.size(), name) == 0 &&
           (name.back() == '/' || path[name.size()] == '/'))) {
        if (name.size() > best.size()) best = name;
      }
    }
    return best.empty() ? path : best;
  }

  uint64_t next_seq() { return seq_.fetch_add(1) + 1; }

  void close_all() {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& [_, q] : queues_) q->close();
  }

 private:
  const uint32_t max_delivery_;
  const double lease_seconds_;
  std::mutex mu_;
  std::map<std::string, std::unique_ptr<EndpointQueue>> queues_;
  std::atomic<uint64_t> seq_{0};
};

// Leased messages handed across the ABI; freed with bc_free_message.
struct MessageView {
  uint64_t seq;
  uint32_t delivery_count;
  const char* task_id;
  const char* endpoint;
  const char* content_type;
  const uint8_t* body;
  uint64_t body_len;
  Message* owner;  // keepalive
};

}  // namespace

extern "C" {

void* bc_create(uint32_t max_delivery, double lease_seconds) {
  return new Broker(max_delivery, lease_seconds);
}

// Wake all blocked receivers (they return null); does NOT free memory, so
// in-flight bc_receive calls stay valid. Call before bc_destroy.
void bc_close(void* handle) {
  static_cast<Broker*>(handle)->close_all();
}

void bc_destroy(void* handle) {
  auto* b = static_cast<Broker*>(handle);
  b->close_all();
  delete b;
}

void bc_register_queue(void* handle, const char* name) {
  static_cast<Broker*>(handle)->queue(name);
}

uint64_t bc_publish(void* handle, const char* path, const char* task_id,
                    const char* endpoint, const char* content_type,
                    const uint8_t* body, uint64_t body_len) {
  auto* b = static_cast<Broker*>(handle);
  auto msg = std::make_shared<Message>();
  msg->seq = b->next_seq();
  msg->task_id = task_id;
  msg->endpoint = endpoint;
  msg->content_type = content_type;
  msg->body.assign(body, body + body_len);
  const uint64_t seq = msg->seq;
  b->queue(b->resolve(path))->put(std::move(msg));
  return seq;
}

// Returns a MessageView* or nullptr on timeout. Caller frees with
// bc_free_message.
void* bc_receive(void* handle, const char* queue_name, int64_t timeout_ms) {
  auto* b = static_cast<Broker*>(handle);
  auto msg = b->queue(queue_name)->receive(timeout_ms);
  if (!msg) return nullptr;
  auto* keep = new Message(*msg);  // stable snapshot for the view
  auto* view = new MessageView{
      msg->seq,           msg->delivery_count, keep->task_id.c_str(),
      keep->endpoint.c_str(), keep->content_type.c_str(),
      keep->body.data(),  keep->body.size(),   keep};
  return view;
}

void bc_free_message(void* view_ptr) {
  auto* view = static_cast<MessageView*>(view_ptr);
  delete view->owner;
  delete view;
}

void bc_complete(void* handle, const char* queue_name, uint64_t seq) {
  static_cast<Broker*>(handle)->queue(queue_name)->complete(seq);
}

int bc_abandon(void* handle, const char* queue_name, uint64_t seq) {
  return static_cast<Broker*>(handle)->queue(queue_name)->abandon(seq);
}

void* bc_pop_dead_letter(void* handle, const char* queue_name) {
  auto msg = static_cast<Broker*>(handle)->queue(queue_name)->pop_dead_letter();
  if (!msg) return nullptr;
  auto* keep = new Message(*msg);
  auto* view = new MessageView{
      msg->seq,           msg->delivery_count, keep->task_id.c_str(),
      keep->endpoint.c_str(), keep->content_type.c_str(),
      keep->body.data(),  keep->body.size(),   keep};
  return view;
}

uint64_t bc_depth(void* handle, const char* queue_name) {
  return static_cast<Broker*>(handle)->queue(queue_name)->depth();
}

uint64_t bc_in_flight(void* handle, const char* queue_name) {
  return static_cast<Broker*>(handle)->queue(queue_name)->in_flight();
}

}  // extern "C"
