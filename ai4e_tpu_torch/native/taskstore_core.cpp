// taskstore_core — native task state-machine engine; a copy of the JAX
// package's native/taskstore_core.cpp.
//
// The same state machine as the Python InMemoryTaskStore (create/transition
// with per-endpoint per-status sets and the original-body replay) in C++
// behind one mutex, exposed through a C ABI consumed from Python via ctypes
// (ai4e_tpu_torch/taskstore/native.py). Publishing/listener side-effects
// stay in Python — the engine returns the effective record (with the
// replayed body) and a publish flag, and the wrapper drives the broker
// exactly like InMemoryTaskStore does.
//
// Built on first use by ai4e_tpu_torch/utils/native_build.py:
// g++ -O2 -shared -fPIC -std=c++17 taskstore_core.cpp -o libtaskstore_core.so

#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

double now_seconds() {
  return static_cast<double>(
             std::chrono::duration_cast<std::chrono::microseconds>(
                 std::chrono::system_clock::now().time_since_epoch())
                 .count()) /
         1e6;
}

std::string lower(const std::string& s) {
  std::string out(s);
  for (auto& c : out) c = static_cast<char>(std::tolower(c));
  return out;
}

// TaskStatus.canonical (taskstore/task.py): bucket free-form status
// strings.
std::string canonical_status(const std::string& status) {
  const std::string s = lower(status);
  for (const char* canon : {"failed", "completed", "running"}) {
    if (s.find(canon) != std::string::npos) return canon;
  }
  return "created";
}

// endpoint_path (task.py:51-58): strip scheme://host, keep the path only —
// query/fragment must not leak into set keys (urlparse().path drops them;
// divergent keys would split one endpoint's depth metrics).
std::string endpoint_path(const std::string& endpoint) {
  if (endpoint.empty()) return "";
  std::string path;
  auto scheme = endpoint.find("://");
  if (scheme == std::string::npos) {
    path = endpoint[0] == '/' ? endpoint : "/" + endpoint;
  } else {
    // The path starts at the first '/' AFTER the authority — a '/' inside
    // the query/fragment of a host-only URL ("http://h?next=/a") is NOT a
    // path (urlparse gives "", i.e. "/").
    auto mark = endpoint.find_first_of("/?#", scheme + 3);
    if (mark == std::string::npos || endpoint[mark] != '/') return "/";
    path = endpoint.substr(mark);
  }
  auto cut = path.find_first_of("?#");
  if (cut != std::string::npos) path = path.substr(0, cut);
  return path.empty() ? "/" : path;
}

std::string new_task_id() {
  // GUID-shaped ids (CacheConnectorUpsert.cs:99 Guid.NewGuid()).
  static thread_local std::mt19937_64 rng{std::random_device{}()};
  static const char* hex = "0123456789abcdef";
  std::string id = "xxxxxxxx-xxxx-4xxx-yxxx-xxxxxxxxxxxx";
  for (auto& c : id) {
    if (c == 'x') {
      c = hex[rng() & 15];
    } else if (c == 'y') {
      c = hex[8 | (rng() & 3)];
    }
  }
  return id;
}

struct Task {
  std::string task_id;
  double timestamp = 0.0;
  std::string status = "created";
  std::string backend_status = "created";
  std::string endpoint;
  std::vector<uint8_t> body;
  std::string content_type = "application/json";
  bool publish = false;
};

struct Blob {
  std::vector<uint8_t> data;
  std::string content_type;
};

class TaskStoreCore {
 public:
  // Returns the stored record; creates or transitions per
  // CacheConnectorUpsert.TaskRun semantics.
  Task upsert(Task task) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tasks_.find(task.task_id);
    if (task.task_id.empty() || it == tasks_.end()) {
      if (task.task_id.empty()) task.task_id = new_task_id();
      if (!task.body.empty()) {
        orig_[task.task_id] = Blob{task.body, task.content_type};
      }
    } else {
      Task& prev = it->second;
      if (task.body.empty() && task.publish) {
        // Subsequent pipeline call: replay the original body + type
        // (CacheConnectorUpsert.cs:144-176).
        auto o = orig_.find(task.task_id);
        if (o != orig_.end()) {
          task.body = o->second.data;
          task.content_type = o->second.content_type;
        }
      } else if (!task.body.empty() && task.publish) {
        // Handoff with a fresh payload becomes the new replay body.
        orig_[task.task_id] = Blob{task.body, task.content_type};
      }
      remove_from_set(prev);
    }
    task.timestamp = now_seconds();
    add_to_set(task);
    tasks_[task.task_id] = task;
    return task;
  }

  bool update_status(const std::string& id, const std::string& status,
                     const char* backend_status, Task* out) {
    std::lock_guard<std::mutex> lk(mu_);
    return update_locked(id, status, backend_status, out);
  }

  bool update_status_if(const std::string& id, const std::string& expected,
                        const std::string& status,
                        const char* backend_status, Task* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tasks_.find(id);
    if (it == tasks_.end() ||
        canonical_status(it->second.status) != expected) {
      return false;
    }
    return update_locked(id, status, backend_status, out);
  }

  // Conditional republish (reaper rescue): reset to created with the
  // original body, publish=true — iff still in `expected`.
  bool requeue_if(const std::string& id, const std::string& expected,
                  Task* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tasks_.find(id);
    if (it == tasks_.end() ||
        canonical_status(it->second.status) != expected) {
      return false;
    }
    Task& prev = it->second;
    Task task;
    task.task_id = id;
    task.endpoint = prev.endpoint;
    task.status = task.backend_status = "created";
    task.content_type = prev.content_type;
    task.publish = true;
    auto o = orig_.find(id);
    if (o != orig_.end()) {
      task.body = o->second.data;
      task.content_type = o->second.content_type;
    }
    remove_from_set(prev);
    task.timestamp = now_seconds();
    add_to_set(task);
    tasks_[id] = task;
    *out = task;
    return true;
  }

  bool get(const std::string& id, Task* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = tasks_.find(id);
    if (it == tasks_.end()) return false;
    *out = it->second;
    return true;
  }

  bool get_original(const std::string& id, Blob* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = orig_.find(id);
    if (it == orig_.end()) return false;
    *out = it->second;
    return true;
  }

  bool set_result(const std::string& id, const std::string& key,
                  Blob blob) {
    std::lock_guard<std::mutex> lk(mu_);
    if (tasks_.find(id) == tasks_.end()) return false;
    results_[key] = std::move(blob);
    return true;
  }

  bool get_result(const std::string& key, Blob* out) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = results_.find(key);
    if (it == results_.end()) return false;
    *out = it->second;
    return true;
  }

  uint64_t set_len(const std::string& path, const std::string& status) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = sets_.find(path + "\x1f" + status);
    return it == sets_.end() ? 0 : it->second.size();
  }

  // "id\x1fscore\n" lines for ONE set, score-ordered — the reaper's
  // per-endpoint sweep query (a full dump per endpoint would be O(E) full
  // serializations per sweep).
  std::string dump_members(const std::string& path,
                           const std::string& status) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string out;
    auto it = sets_.find(path + "\x1f" + status);
    if (it == sets_.end()) return out;
    std::multimap<double, const std::string*> ordered;
    for (const auto& [id, score] : it->second) ordered.emplace(score, &id);
    for (const auto& [score, id] : ordered) {
      out += *id;
      out += '\x1f';
      out += std::to_string(score);
      out += '\n';
    }
    return out;
  }

  // "path\x1fstatus\x1fid\x1fscore\n" lines, members score-ordered — one
  // string the wrapper parses for set_members/endpoints/depths/snapshot.
  std::string dump_sets() {
    std::lock_guard<std::mutex> lk(mu_);
    std::string out;
    for (const auto& [key, members] : sets_) {
      std::multimap<double, const std::string*> ordered;
      for (const auto& [id, score] : members) ordered.emplace(score, &id);
      for (const auto& [score, id] : ordered) {
        out += key;
        out += '\x1f';
        out += *id;
        out += '\x1f';
        out += std::to_string(score);
        out += '\n';
      }
      if (members.empty()) {
        out += key;
        out += "\x1f\x1f\n";  // keep empty sets visible for depths()
      }
    }
    return out;
  }

 private:
  bool update_locked(const std::string& id, const std::string& status,
                     const char* backend_status, Task* out) {
    auto it = tasks_.find(id);
    if (it == tasks_.end()) return false;
    Task& prev = it->second;
    remove_from_set(prev);
    prev.status = status;
    prev.backend_status = backend_status ? backend_status : status;
    prev.timestamp = now_seconds();
    prev.publish = false;
    add_to_set(prev);
    *out = prev;
    return true;
  }

  void add_to_set(const Task& t) {
    sets_[endpoint_path(t.endpoint) + "\x1f" + canonical_status(t.status)]
        [t.task_id] = t.timestamp;
  }

  void remove_from_set(const Task& t) {
    auto it = sets_.find(endpoint_path(t.endpoint) + "\x1f" +
                         canonical_status(t.status));
    if (it != sets_.end()) it->second.erase(t.task_id);
  }

  std::mutex mu_;
  std::unordered_map<std::string, Task> tasks_;
  std::unordered_map<std::string, Blob> orig_;
  std::unordered_map<std::string, Blob> results_;
  // key: "path\x1fstatus" -> {task_id: score}
  std::map<std::string, std::unordered_map<std::string, double>> sets_;
};

// -- C ABI -------------------------------------------------------------------

struct TaskView {
  double timestamp;
  int32_t publish;
  const char* task_id;
  const char* status;
  const char* backend_status;
  const char* endpoint;
  const char* content_type;
  const uint8_t* body;
  uint64_t body_len;
  void* owner;
};

struct ViewOwner {
  Task task;
};

TaskView* make_view(Task task) {
  auto* owner = new ViewOwner{std::move(task)};
  auto* v = new TaskView();
  const Task& t = owner->task;
  v->timestamp = t.timestamp;
  v->publish = t.publish ? 1 : 0;
  v->task_id = t.task_id.c_str();
  v->status = t.status.c_str();
  v->backend_status = t.backend_status.c_str();
  v->endpoint = t.endpoint.c_str();
  v->content_type = t.content_type.c_str();
  v->body = t.body.data();
  v->body_len = t.body.size();
  v->owner = owner;
  return v;
}

}  // namespace

extern "C" {

void* tsc_create() { return new TaskStoreCore(); }

void tsc_destroy(void* h) { delete static_cast<TaskStoreCore*>(h); }

TaskView* tsc_upsert(void* h, const char* task_id, const char* endpoint,
                     const char* status, const char* backend_status,
                     const uint8_t* body, uint64_t body_len,
                     const char* content_type, int publish) {
  Task t;
  t.task_id = task_id ? task_id : "";
  t.endpoint = endpoint ? endpoint : "";
  t.status = status && *status ? status : "created";
  t.backend_status =
      backend_status && *backend_status ? backend_status : t.status;
  if (body_len) t.body.assign(body, body + body_len);
  if (content_type && *content_type) t.content_type = content_type;
  t.publish = publish != 0;
  return make_view(static_cast<TaskStoreCore*>(h)->upsert(std::move(t)));
}

TaskView* tsc_update_status(void* h, const char* id, const char* status,
                            const char* backend_status) {
  Task out;
  if (!static_cast<TaskStoreCore*>(h)->update_status(id, status,
                                                     backend_status, &out)) {
    return nullptr;
  }
  return make_view(std::move(out));
}

TaskView* tsc_update_status_if(void* h, const char* id, const char* expected,
                               const char* status,
                               const char* backend_status) {
  Task out;
  if (!static_cast<TaskStoreCore*>(h)->update_status_if(
          id, expected, status, backend_status, &out)) {
    return nullptr;
  }
  return make_view(std::move(out));
}

TaskView* tsc_requeue_if(void* h, const char* id, const char* expected) {
  Task out;
  if (!static_cast<TaskStoreCore*>(h)->requeue_if(id, expected, &out)) {
    return nullptr;
  }
  return make_view(std::move(out));
}

TaskView* tsc_get(void* h, const char* id) {
  Task out;
  if (!static_cast<TaskStoreCore*>(h)->get(id, &out)) return nullptr;
  return make_view(std::move(out));
}

TaskView* tsc_get_original(void* h, const char* id) {
  Blob blob;
  if (!static_cast<TaskStoreCore*>(h)->get_original(id, &blob)) {
    return nullptr;
  }
  Task t;
  t.body = std::move(blob.data);
  t.content_type = std::move(blob.content_type);
  return make_view(std::move(t));
}

int tsc_set_result(void* h, const char* id, const char* key,
                   const uint8_t* data, uint64_t len,
                   const char* content_type) {
  Blob blob;
  if (len) blob.data.assign(data, data + len);
  blob.content_type = content_type ? content_type : "application/json";
  return static_cast<TaskStoreCore*>(h)->set_result(id, key, std::move(blob))
             ? 1
             : 0;
}

TaskView* tsc_get_result(void* h, const char* key) {
  Blob blob;
  if (!static_cast<TaskStoreCore*>(h)->get_result(key, &blob)) {
    return nullptr;
  }
  Task t;
  t.body = std::move(blob.data);
  t.content_type = std::move(blob.content_type);
  return make_view(std::move(t));
}

uint64_t tsc_set_len(void* h, const char* path, const char* status) {
  return static_cast<TaskStoreCore*>(h)->set_len(path, status);
}

char* tsc_dump_sets(void* h) {
  std::string s = static_cast<TaskStoreCore*>(h)->dump_sets();
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.data(), s.size() + 1);
  return out;
}

char* tsc_dump_members(void* h, const char* path, const char* status) {
  std::string s = static_cast<TaskStoreCore*>(h)->dump_members(path, status);
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.data(), s.size() + 1);
  return out;
}

void tsc_free_str(char* s) { std::free(s); }

void tsc_free_view(TaskView* v) {
  if (!v) return;
  delete static_cast<ViewOwner*>(v->owner);
  delete v;
}

}  // extern "C"
