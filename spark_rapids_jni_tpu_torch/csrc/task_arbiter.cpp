// Multi-tenant memory-governance state machine (native core).
//
// Re-expression of the reference's SparkResourceAdaptorJni.cpp (2171 LoC): the
// arbiter that lets N concurrent partition tasks share one accelerator's
// memory with priority-based blocking, Block-Until-Further-Notice escalation,
// split-and-retry signaling, deadlock breaking, failure injection and
// per-task metrics.  Design mapping (file:line refer to the reference):
//
// - thread_state enum            <- SparkResourceAdaptorJni.cpp:75-95
// - thread_priority              <- :135-190 (lower task id = higher priority,
//                                  non-task threads highest via task_id -1)
// - block_thread_until_ready     <- :1036-1110
// - pre_alloc / injection        <- :1236-1324
// - post_alloc_success/failed    <- :1336,:1685-1729
// - dealloc (ALLOC->ALLOC_FREE + wake) <- :1754-1788
// - wake_next_highest_priority_blocked <- :1379-1483
// - is_in_deadlock two-pass      <- :1506-1591
// - check_and_update_for_bufn    <- :1598-1672
// - 500-retry livelock cap       <- :982-993
// - CSV transition log           <- :116-133,:396-399,:897-919
// - task_metrics checkpointing   <- :197-227,:960-976
//
// Differences from the reference, forced by the platform:
// - No JNI: a C API consumed via ctypes; exceptions become negative return
//   codes the Python layer re-raises as the RetryOOM hierarchy.
// - Thread ids are passed in explicitly (Python threading idents) instead of
//   pthread_self(), so the GIL-holding thread mapping stays explicit.
// - The JVM ThreadStateRegistry.isThreadBlocked callback (used so the
//   deadlock detector can see JVM-level blocking, :42-73) becomes an
//   "externally blocked" flag the host sets per thread.
// - Allocation interception: on TPU the governed resource is batch admission
//   into an HBM budget rather than malloc; the Python governor drives the
//   same pre_alloc/post_alloc/dealloc protocol around budget reservations.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// ---- return codes (mirrored in python mem.exceptions) ----
enum arbiter_code : int {
  ARB_OK                 = 0,
  ARB_RECURSIVE          = 1,  // pre_alloc: recursive (spill) allocation
  ARB_GPU_RETRY_OOM      = -1,
  ARB_GPU_SPLIT_RETRY    = -2,
  ARB_CPU_RETRY_OOM      = -3,
  ARB_CPU_SPLIT_RETRY    = -4,
  ARB_INJECTED_EXCEPTION = -5,
  ARB_OOM                = -6,  // real OOM / livelock limit
  ARB_THREAD_REMOVED     = -7,
  ARB_INVALID            = -8,
  ARB_INTERNAL           = -9,
};

namespace {

enum class thread_state : int {
  UNKNOWN       = -1,
  RUNNING       = 0,
  ALLOC         = 1,
  ALLOC_FREE    = 2,
  BLOCKED       = 3,
  BUFN_THROW    = 4,
  BUFN_WAIT     = 5,
  BUFN          = 6,
  SPLIT_THROW   = 7,
  REMOVE_THROW  = 8,
};

const char* as_str(thread_state s)
{
  switch (s) {
    case thread_state::RUNNING: return "THREAD_RUNNING";
    case thread_state::ALLOC: return "THREAD_ALLOC";
    case thread_state::ALLOC_FREE: return "THREAD_ALLOC_FREE";
    case thread_state::BLOCKED: return "THREAD_BLOCKED";
    case thread_state::BUFN_THROW: return "THREAD_BUFN_THROW";
    case thread_state::BUFN_WAIT: return "THREAD_BUFN_WAIT";
    case thread_state::BUFN: return "THREAD_BUFN";
    case thread_state::SPLIT_THROW: return "THREAD_SPLIT_THROW";
    case thread_state::REMOVE_THROW: return "THREAD_REMOVE_THROW";
    default: return "UNKNOWN";
  }
}

thread_local std::string g_last_error;

struct arb_exception {  // internal control-flow signal -> return code
  int code;
  std::string msg;
};

[[noreturn]] void throw_code(int code, std::string msg)
{
  throw arb_exception{code, std::move(msg)};
}

class thread_priority {
 public:
  thread_priority(int64_t tsk, int64_t thr) : task_id(tsk), thread_id(thr) {}
  int64_t get_thread_id() const { return thread_id; }
  bool operator<(thread_priority const& o) const
  {
    int64_t const a = task_priority(), b = o.task_priority();
    return a < b || (a == b && thread_id < o.thread_id);
  }

 private:
  int64_t task_id;
  int64_t thread_id;
  int64_t task_priority() const
  {
    return std::numeric_limits<int64_t>::max() - (task_id + 1);
  }
};

struct task_metrics {
  int64_t num_times_retry_throw       = 0;
  int64_t num_times_split_retry_throw = 0;
  int64_t time_blocked_nanos          = 0;
  int64_t time_lost_nanos             = 0;  // compute time lost to retry

  void add(task_metrics const& o)
  {
    num_times_retry_throw += o.num_times_retry_throw;
    num_times_split_retry_throw += o.num_times_split_retry_throw;
    time_blocked_nanos += o.time_blocked_nanos;
    time_lost_nanos += o.time_lost_nanos;
  }
  void take_from(task_metrics& o)
  {
    add(o);
    o.clear();
  }
  void clear() { *this = task_metrics(); }
};

int64_t now_ns()
{
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
           std::chrono::steady_clock::now().time_since_epoch())
    .count();
}

struct oom_injection {
  int skip_count = 0;
  int hit_count  = 0;
  int oom_filter = 0;  // 0 none, 1 CPU, 2 GPU, 3 both (OomInjectionType)
  bool matches(bool is_for_cpu) const
  {
    return (is_for_cpu && (oom_filter & 1)) || (!is_for_cpu && (oom_filter & 2));
  }
};

struct full_thread_state {
  thread_state state = thread_state::UNKNOWN;
  int64_t thread_id  = -1;
  int64_t task_id    = -1;  // -1 == pool/shuffle thread
  std::set<int64_t> pool_task_ids;
  bool is_cpu_alloc = false;
  // pool-blocked tracking (submittingToPool/waitingOnPool :344-399)
  bool pool_blocked = false;
  // host-set analog of ThreadStateRegistry.isThreadBlocked
  bool externally_blocked = false;

  oom_injection retry_oom;
  oom_injection split_and_retry_oom;
  int cudf_exception_injected = 0;
  int num_times_retried       = 0;  // livelock cap counter

  task_metrics metrics;
  int64_t block_start      = 0;
  int64_t retry_start      = 0;  // for lost-compute accounting

  std::unique_ptr<std::condition_variable> wake_condition =
    std::make_unique<std::condition_variable>();

  thread_priority priority() const { return thread_priority(task_id, thread_id); }

  void before_block() { block_start = now_ns(); }
  void after_block()
  {
    metrics.time_blocked_nanos += now_ns() - block_start;
    retry_start = now_ns();
  }
  void record_failed_retry_time()
  {
    if (retry_start != 0) {
      metrics.time_lost_nanos += now_ns() - retry_start;
      retry_start = now_ns();
    }
  }
};

class task_arbiter {
 public:
  explicit task_arbiter(char const* log_path)
  {
    if (log_path != nullptr && std::strlen(log_path) > 0) {
      if (std::strcmp(log_path, "stderr") == 0) {
        log_ = stderr;
      } else if (std::strcmp(log_path, "stdout") == 0) {
        log_ = stdout;
      } else {
        log_       = std::fopen(log_path, "w");
        owns_log_ = log_ != nullptr;
      }
      if (log_ != nullptr) {
        std::fprintf(log_, "time,op,current thread,op thread,op task,from state,to state,notes\n");
      }
    }
  }

  ~task_arbiter()
  {
    if (owns_log_ && log_ != nullptr) { std::fclose(log_); }
  }

  // ---- registration -------------------------------------------------------

  void start_dedicated_task_thread(int64_t thread_id, int64_t task_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) {
      if (found->second.task_id != task_id) {
        remove_thread_association_core(found->second, -1, lock);
      } else {
        return;
      }
    }
    auto& st     = threads_[thread_id];
    st.thread_id = thread_id;
    st.task_id   = task_id;
    st.state     = thread_state::RUNNING;
    log_transition(thread_id, task_id, thread_state::UNKNOWN, thread_state::RUNNING);
  }

  void pool_thread_working_on_task(int64_t thread_id, int64_t task_id, bool is_shuffle)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto& st = threads_[thread_id];
    if (st.state == thread_state::UNKNOWN) {
      st.thread_id = thread_id;
      st.task_id   = -1;
      st.state     = thread_state::RUNNING;
      log_transition(thread_id, -1, thread_state::UNKNOWN, thread_state::RUNNING);
    }
    (void)is_shuffle;  // shuffle threads are pool threads: task_id -1 == top priority
    st.pool_task_ids.insert(task_id);
  }

  void pool_thread_finished_for_task(int64_t thread_id, int64_t task_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found == threads_.end()) { return; }
    found->second.pool_task_ids.erase(task_id);
    if (found->second.pool_task_ids.empty()) {
      remove_thread_association_core(found->second, -1, lock);
    }
  }

  void remove_thread_association(int64_t thread_id, int64_t task_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) {
      remove_thread_association_core(found->second, task_id, lock);
    }
  }

  void task_done(int64_t task_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    std::vector<int64_t> to_remove;
    for (auto& [tid, st] : threads_) {
      if (st.task_id == task_id) {
        to_remove.push_back(tid);
      } else {
        st.pool_task_ids.erase(task_id);
        if (st.task_id < 0 && st.pool_task_ids.empty()) { to_remove.push_back(tid); }
      }
    }
    for (auto tid : to_remove) {
      auto found = threads_.find(tid);
      if (found != threads_.end()) {
        remove_thread_association_core(found->second, -1, lock);
      }
    }
    task_to_metrics_.erase(task_id);  // task complete; metrics were read
  }

  void set_pool_blocked(int64_t thread_id, bool blocked)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) { found->second.pool_blocked = blocked; }
    if (!blocked) { task_has_woken_.notify_all(); }
  }

  void set_externally_blocked(int64_t thread_id, bool blocked)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) { found->second.externally_blocked = blocked; }
  }

  // ---- retry blocks / injection ------------------------------------------

  void start_retry_block(int64_t thread_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) { found->second.retry_start = now_ns(); }
  }

  void end_retry_block(int64_t thread_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto found = threads_.find(thread_id);
    if (found != threads_.end()) {
      found->second.retry_start       = 0;
      found->second.num_times_retried = 0;
    }
  }

  void force_retry_oom(int64_t thread_id, int num_ooms, int oom_filter, int skip_count)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto& st                    = get_thread(thread_id);
    st.retry_oom.hit_count      = num_ooms;
    st.retry_oom.skip_count     = skip_count;
    st.retry_oom.oom_filter     = oom_filter;
  }

  void force_split_and_retry_oom(int64_t thread_id, int num_ooms, int oom_filter, int skip_count)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto& st                             = get_thread(thread_id);
    st.split_and_retry_oom.hit_count     = num_ooms;
    st.split_and_retry_oom.skip_count    = skip_count;
    st.split_and_retry_oom.oom_filter    = oom_filter;
  }

  void force_cudf_exception(int64_t thread_id, int num_times)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    get_thread(thread_id).cudf_exception_injected = num_times;
  }

  // ---- alloc protocol -----------------------------------------------------

  int pre_alloc(int64_t thread_id, bool is_for_cpu, bool blocking)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto const thread = threads_.find(thread_id);
    if (thread != threads_.end()) {
      switch (thread->second.state) {
        case thread_state::ALLOC:
        case thread_state::ALLOC_FREE:
          // recursive allocation (spill inside alloc) (:1244-1261)
          if (is_for_cpu && blocking) {
            throw_code(ARB_INVALID,
                       "blocking admission request from thread " +
                         std::to_string(thread_id) + " rejected: thread is mid-allocation (" +
                         as_str(thread->second.state) + ")");
          }
          return ARB_RECURSIVE;
        default: break;
      }

      auto& st = thread->second;
      if (st.retry_oom.matches(is_for_cpu)) {
        if (st.retry_oom.skip_count > 0) {
          st.retry_oom.skip_count--;
        } else if (st.retry_oom.hit_count > 0) {
          st.retry_oom.hit_count--;
          st.metrics.num_times_retry_throw++;
          log_status(is_for_cpu ? "INJECTED_RETRY_OOM_CPU" : "INJECTED_RETRY_OOM_GPU",
                     thread_id, st.task_id, st.state);
          st.record_failed_retry_time();
          throw_code(is_for_cpu ? ARB_CPU_RETRY_OOM : ARB_GPU_RETRY_OOM, "fault injection: forced retry OOM");
        }
      }
      if (st.cudf_exception_injected > 0) {
        st.cudf_exception_injected--;
        log_status("INJECTED_EXCEPTION", thread_id, st.task_id, st.state);
        st.record_failed_retry_time();
        throw_code(ARB_INJECTED_EXCEPTION, "injected framework exception");
      }
      if (st.split_and_retry_oom.matches(is_for_cpu)) {
        if (st.split_and_retry_oom.skip_count > 0) {
          st.split_and_retry_oom.skip_count--;
        } else if (st.split_and_retry_oom.hit_count > 0) {
          st.split_and_retry_oom.hit_count--;
          st.metrics.num_times_split_retry_throw++;
          log_status(is_for_cpu ? "INJECTED_SPLIT_AND_RETRY_OOM_CPU"
                                : "INJECTED_SPLIT_AND_RETRY_OOM_GPU",
                     thread_id, st.task_id, st.state);
          st.record_failed_retry_time();
          throw_code(is_for_cpu ? ARB_CPU_SPLIT_RETRY : ARB_GPU_SPLIT_RETRY,
                     "fault injection: forced split-and-retry OOM");
        }
      }

      if (blocking) { block_thread_until_ready_core(thread_id, lock); }

      auto const again = threads_.find(thread_id);
      if (again == threads_.end()) { return ARB_OK; }
      switch (again->second.state) {
        case thread_state::RUNNING:
          transition(again->second, thread_state::ALLOC);
          again->second.is_cpu_alloc = is_for_cpu;
          break;
        default:
          throw_code(ARB_INVALID,
                     "admission precheck: thread " + std::to_string(thread_id) +
                       " cannot start an allocation from state " + as_str(again->second.state));
      }
    }
    return ARB_OK;
  }

  void post_alloc_success(int64_t thread_id, bool is_for_cpu, bool was_recursive)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto const thread = threads_.find(thread_id);
    if (!was_recursive && thread != threads_.end()) {
      switch (thread->second.state) {
        case thread_state::ALLOC:
        case thread_state::ALLOC_FREE:
          transition(thread->second, thread_state::RUNNING);
          thread->second.is_cpu_alloc = false;
          break;
        default: break;
      }
      wake_next_highest_priority_blocked(lock, false, is_for_cpu);
    }
  }

  bool post_alloc_failed(
    int64_t thread_id, bool is_for_cpu, bool is_oom, bool blocking, bool was_recursive)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto const thread = threads_.find(thread_id);
    bool ret          = true;
    if (!was_recursive && thread != threads_.end()) {
      if (thread->second.is_cpu_alloc != is_for_cpu) {
        throw_code(ARB_INVALID,
                   "thread " + std::to_string(thread_id) +
                     " has a mismatch on CPU vs GPU post alloc");
      }
      switch (thread->second.state) {
        case thread_state::ALLOC_FREE:
          transition(thread->second, thread_state::RUNNING);
          break;
        case thread_state::ALLOC:
          if (is_oom && blocking) {
            transition(thread->second, thread_state::BLOCKED);
          } else {
            transition(thread->second, thread_state::RUNNING);
          }
          break;
        default:
          throw_code(ARB_INTERNAL, "unexpected state after alloc failed");
      }
    } else {
      ret = false;
    }
    check_and_update_for_bufn(lock);
    return ret;
  }

  void dealloc(int64_t thread_id, bool is_for_cpu)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto const thread = threads_.find(thread_id);
    if (thread != threads_.end()) {
      log_status("DEALLOC", thread_id, thread->second.task_id, thread->second.state);
    } else {
      log_status("DEALLOC", thread_id, -2, thread_state::UNKNOWN);
    }
    for (auto& [tid, st] : threads_) {
      if (tid != thread_id && st.state == thread_state::ALLOC &&
          st.is_cpu_alloc == is_for_cpu) {
        transition(st, thread_state::ALLOC_FREE);
      }
    }
    wake_next_highest_priority_blocked(lock, true, is_for_cpu);
  }

  int block_thread_until_ready(int64_t thread_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    block_thread_until_ready_core(thread_id, lock);
    return ARB_OK;
  }

  void check_and_break_deadlocks()
  {
    std::unique_lock<std::mutex> lock(mutex_);
    check_and_update_for_bufn(lock);
  }

  // ---- introspection / metrics -------------------------------------------

  int get_state_of(int64_t thread_id)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    auto const found = threads_.find(thread_id);
    return found == threads_.end() ? -1 : static_cast<int>(found->second.state);
  }

  int64_t get_and_reset_metric(int64_t task_id, int which)
  {
    std::unique_lock<std::mutex> lock(mutex_);
    // fold live thread metrics into the task accumulator first
    for (auto& [tid, st] : threads_) {
      if (st.task_id == task_id || st.pool_task_ids.count(task_id)) {
        checkpoint_metrics(st);
      }
    }
    auto found = task_to_metrics_.find(task_id);
    if (found == task_to_metrics_.end()) { return 0; }
    int64_t out = 0;
    switch (which) {
      case 0: out = found->second.num_times_retry_throw;
              found->second.num_times_retry_throw = 0; break;
      case 1: out = found->second.num_times_split_retry_throw;
              found->second.num_times_split_retry_throw = 0; break;
      case 2: out = found->second.time_blocked_nanos;
              found->second.time_blocked_nanos = 0; break;
      case 3: out = found->second.time_lost_nanos;
              found->second.time_lost_nanos = 0; break;
      default: break;
    }
    return out;
  }

  int64_t get_total_blocked_or_bufn()
  {
    std::unique_lock<std::mutex> lock(mutex_);
    int64_t count = 0;
    for (auto const& [tid, st] : threads_) {
      switch (st.state) {
        case thread_state::BLOCKED:
        case thread_state::BUFN:
        case thread_state::BUFN_THROW:
        case thread_state::BUFN_WAIT: count++; break;
        default: break;
      }
    }
    return count;
  }

 private:
  std::mutex mutex_;
  std::condition_variable task_has_woken_;
  std::unordered_map<int64_t, full_thread_state> threads_;
  std::unordered_map<int64_t, task_metrics> task_to_metrics_;
  std::FILE* log_  = nullptr;
  bool owns_log_   = false;

  full_thread_state& get_thread(int64_t thread_id)
  {
    auto found = threads_.find(thread_id);
    if (found == threads_.end()) {
      throw_code(ARB_INVALID, "thread " + std::to_string(thread_id) + " is not registered");
    }
    return found->second;
  }

  void log_transition(int64_t thread_id, int64_t task_id, thread_state from, thread_state to)
  {
    if (log_ != nullptr) {
      std::fprintf(log_, "%lld,TRANSITION,%lld,%lld,%lld,%s,%s,\n",
                   static_cast<long long>(now_ns()), 0LL,
                   static_cast<long long>(thread_id), static_cast<long long>(task_id),
                   as_str(from), as_str(to));
      std::fflush(log_);
    }
  }

  void log_status(char const* op, int64_t thread_id, int64_t task_id, thread_state state)
  {
    if (log_ != nullptr) {
      std::fprintf(log_, "%lld,%s,%lld,%lld,%s,,\n", static_cast<long long>(now_ns()), op,
                   static_cast<long long>(thread_id), static_cast<long long>(task_id),
                   as_str(state));
      std::fflush(log_);
    }
  }

  void transition(full_thread_state& st, thread_state to)
  {
    log_transition(st.thread_id, st.task_id, st.state, to);
    st.state = to;
  }

  void checkpoint_metrics(full_thread_state& st)
  {
    if (st.task_id < 0) {
      for (auto const task_id : st.pool_task_ids) {
        task_to_metrics_.try_emplace(task_id, task_metrics())
          .first->second.add(st.metrics);
      }
      st.metrics.clear();
    } else {
      task_to_metrics_.try_emplace(st.task_id, task_metrics())
        .first->second.take_from(st.metrics);
    }
  }

  void remove_thread_association_core(full_thread_state& st,
                                      int64_t task_id,
                                      std::unique_lock<std::mutex>& lock)
  {
    checkpoint_metrics(st);
    bool remove_all = task_id < 0;
    if (!remove_all) {
      st.pool_task_ids.erase(task_id);
      remove_all = st.task_id == task_id || (st.task_id < 0 && st.pool_task_ids.empty());
    }
    if (remove_all) {
      int64_t const tid = st.thread_id;
      if (st.state == thread_state::BLOCKED || st.state == thread_state::BUFN) {
        // wake it so it can throw "thread removed"
        transition(st, thread_state::REMOVE_THROW);
        st.wake_condition->notify_all();
      } else {
        log_transition(tid, st.task_id, st.state, thread_state::UNKNOWN);
        threads_.erase(tid);
      }
      wake_next_highest_priority_blocked(lock, false, true);
      wake_next_highest_priority_blocked(lock, false, false);
    }
  }

  void check_before_oom(full_thread_state& st)
  {
    if (st.num_times_retried + 1 > 500) {
      st.record_failed_retry_time();
      throw_code(ARB_OOM, "OutOfMemory: retry limit exceeded");
    }
    st.num_times_retried++;
  }

  [[noreturn]] void throw_retry_oom(full_thread_state& st)
  {
    st.metrics.num_times_retry_throw++;
    check_before_oom(st);
    st.record_failed_retry_time();
    throw_code(st.is_cpu_alloc ? ARB_CPU_RETRY_OOM : ARB_GPU_RETRY_OOM, "OutOfMemory");
  }

  [[noreturn]] void throw_split_and_retry_oom(full_thread_state& st)
  {
    st.metrics.num_times_split_retry_throw++;
    check_before_oom(st);
    st.record_failed_retry_time();
    throw_code(st.is_cpu_alloc ? ARB_CPU_SPLIT_RETRY : ARB_GPU_SPLIT_RETRY, "OutOfMemory");
  }

  static bool is_blocked(thread_state s)
  {
    return s == thread_state::BLOCKED || s == thread_state::BUFN;
  }

  void block_thread_until_ready_core(int64_t thread_id, std::unique_lock<std::mutex>& lock)
  {
    bool done       = false;
    bool first_time = true;
    while (!done) {
      auto thread = threads_.find(thread_id);
      if (thread == threads_.end()) { return; }
      switch (thread->second.state) {
        case thread_state::BLOCKED:
        case thread_state::BUFN:
          log_status("WAITING", thread_id, thread->second.task_id, thread->second.state);
          thread->second.before_block();
          do {
            thread->second.wake_condition->wait(lock);
            thread = threads_.find(thread_id);
          } while (thread != threads_.end() && is_blocked(thread->second.state));
          if (thread != threads_.end()) { thread->second.after_block(); }
          task_has_woken_.notify_all();
          break;
        case thread_state::BUFN_THROW:
          transition(thread->second, thread_state::BUFN_WAIT);
          thread->second.record_failed_retry_time();
          throw_retry_oom(thread->second);
        case thread_state::BUFN_WAIT: {
          transition(thread->second, thread_state::BUFN);
          // the throw may not have freed anything; re-check deadlock state
          check_and_update_for_bufn(lock);
          auto again = threads_.find(thread_id);
          if (again != threads_.end() && is_blocked(again->second.state)) {
            log_status("WAITING", thread_id, again->second.task_id, again->second.state);
            again->second.before_block();
            do {
              again->second.wake_condition->wait(lock);
              again = threads_.find(thread_id);
            } while (again != threads_.end() && is_blocked(again->second.state));
            if (again != threads_.end()) { again->second.after_block(); }
            task_has_woken_.notify_all();
          }
          break;
        }
        case thread_state::SPLIT_THROW:
          transition(thread->second, thread_state::RUNNING);
          thread->second.record_failed_retry_time();
          throw_split_and_retry_oom(thread->second);
        case thread_state::REMOVE_THROW:
          log_transition(thread_id, thread->second.task_id, thread->second.state,
                         thread_state::UNKNOWN);
          threads_.erase(thread);
          task_has_woken_.notify_all();
          throw_code(ARB_THREAD_REMOVED, "thread removed while blocked");
        default:
          if (!first_time) {
            log_status("DONE WAITING", thread_id, thread->second.task_id,
                       thread->second.state);
          }
          done = true;
      }
      first_time = false;
    }
  }

  void wake_next_highest_priority_blocked(std::unique_lock<std::mutex> const& lock,
                                          bool is_from_free,
                                          bool is_for_cpu)
  {
    thread_priority to_wake(-1, -1);
    bool is_set = false;
    for (auto const& [tid, st] : threads_) {
      if (st.state == thread_state::BLOCKED && st.is_cpu_alloc == is_for_cpu) {
        thread_priority cur = st.priority();
        if (!is_set || to_wake < cur) {
          to_wake = cur;
          is_set  = true;
        }
      }
    }
    int64_t const wake_id = to_wake.get_thread_id();
    if (is_set && wake_id > 0) {
      auto const thread = threads_.find(wake_id);
      if (thread != threads_.end() && thread->second.state == thread_state::BLOCKED) {
        transition(thread->second, thread_state::RUNNING);
        thread->second.wake_condition->notify_all();
      }
    } else if (is_from_free) {
      // all tasks BUFN after a free: wake the highest priority one (:1407-1480)
      std::map<int64_t, int64_t> pool_bufn_count, pool_count;
      std::unordered_set<int64_t> bufn_ids, all_ids;
      is_in_deadlock(pool_bufn_count, pool_count, bufn_ids, all_ids, lock);
      if (!all_ids.empty() && all_ids.size() == bufn_ids.size()) {
        thread_priority bw(-1, -1);
        bool bw_set = false;
        for (auto const& [tid, st] : threads_) {
          if (st.state == thread_state::BUFN && st.is_cpu_alloc == is_for_cpu) {
            thread_priority cur = st.priority();
            if (!bw_set || bw < cur) {
              bw     = cur;
              bw_set = true;
            }
          }
        }
        if (bw_set) {
          int64_t const tid = bw.get_thread_id();
          auto const thread = threads_.find(tid);
          // don't wake yourself on a free (:1452-1456)
          if (thread != threads_.end() && tid != current_caller_) {
            switch (thread->second.state) {
              case thread_state::BUFN:
                transition(thread->second, thread_state::RUNNING);
                thread->second.wake_condition->notify_all();
                break;
              case thread_state::BUFN_WAIT:
                transition(thread->second, thread_state::RUNNING);
                break;
              default: break;
            }
          }
        }
      }
    }
  }

  bool is_thread_bufn_or_above(full_thread_state const& st) const
  {
    if (st.pool_blocked) { return true; }
    switch (st.state) {
      case thread_state::BLOCKED: return false;
      case thread_state::BUFN: return true;
      default: return st.externally_blocked;
    }
  }

  bool is_in_deadlock(std::map<int64_t, int64_t>& pool_bufn_count,
                      std::map<int64_t, int64_t>& pool_count,
                      std::unordered_set<int64_t>& bufn_ids,
                      std::unordered_set<int64_t>& all_ids,
                      std::unique_lock<std::mutex> const& lock) const
  {
    std::unordered_set<int64_t> blocked_ids;
    // pass 1: dedicated task threads
    for (auto const& [tid, st] : threads_) {
      if (st.task_id >= 0) {
        all_ids.insert(st.task_id);
        bool const bufn_plus = is_thread_bufn_or_above(st);
        if (bufn_plus) { bufn_ids.insert(st.task_id); }
        if (bufn_plus || st.state == thread_state::BLOCKED) {
          blocked_ids.insert(st.task_id);
        }
      }
    }
    // pass 2: pool threads
    for (auto const& [tid, st] : threads_) {
      if (st.task_id < 0) {
        for (auto const task_id : st.pool_task_ids) {
          pool_count[task_id] += 1;
        }
        bool const bufn_plus = is_thread_bufn_or_above(st);
        if (bufn_plus) {
          for (auto const task_id : st.pool_task_ids) {
            pool_bufn_count[task_id] += 1;
          }
        }
        if (!bufn_plus && st.state != thread_state::BLOCKED) {
          for (auto const task_id : st.pool_task_ids) {
            blocked_ids.erase(task_id);
          }
        }
      }
    }
    return !all_ids.empty() && all_ids.size() == blocked_ids.size();
  }

  void check_and_update_for_bufn(std::unique_lock<std::mutex> const& lock)
  {
    std::map<int64_t, int64_t> pool_bufn_count, pool_count;
    std::unordered_set<int64_t> bufn_ids, all_ids;
    bool const deadlocked =
      is_in_deadlock(pool_bufn_count, pool_count, bufn_ids, all_ids, lock);
    if (!deadlocked) { return; }

    // lowest-priority BLOCKED thread -> BUFN_THROW (:1607-1630)
    thread_priority to_bufn(-1, -1);
    bool bufn_set = false;
    for (auto const& [tid, st] : threads_) {
      if (st.state == thread_state::BLOCKED) {
        thread_priority cur = st.priority();
        if (!bufn_set || cur < to_bufn) {
          to_bufn  = cur;
          bufn_set = true;
        }
      }
    }
    if (bufn_set) {
      auto const thread = threads_.find(to_bufn.get_thread_id());
      if (thread != threads_.end()) {
        transition(thread->second, thread_state::BUFN_THROW);
        thread->second.wake_condition->notify_all();
      }
    }

    // a task is BUFN if all its pool threads are BUFN (:1639-1645)
    for (auto const& [task_id, bufn_cnt] : pool_bufn_count) {
      auto const it = pool_count.find(task_id);
      if (it != pool_count.end() && it->second <= bufn_cnt) { bufn_ids.insert(task_id); }
    }

    if (!all_ids.empty() && all_ids.size() == bufn_ids.size()) {
      // everyone is BUFN: highest priority BUFN thread -> SPLIT_THROW (:1647-1670)
      thread_priority to_wake(-1, -1);
      bool wake_set = false;
      for (auto const& [tid, st] : threads_) {
        if (st.state == thread_state::BUFN) {
          thread_priority cur = st.priority();
          if (!wake_set || to_wake < cur) {
            to_wake  = cur;
            wake_set = true;
          }
        }
      }
      if (wake_set) {
        auto const thread = threads_.find(to_wake.get_thread_id());
        if (thread != threads_.end()) {
          transition(thread->second, thread_state::SPLIT_THROW);
          thread->second.wake_condition->notify_all();
        }
      }
    }
  }

 public:
  // set per-call by the C wrappers so "don't wake yourself" checks work
  thread_local static int64_t current_caller_;
};

thread_local int64_t task_arbiter::current_caller_ = -1;

int wrap(task_arbiter* arb, int64_t caller, std::function<int()> fn)
{
  task_arbiter::current_caller_ = caller;
  try {
    return fn();
  } catch (arb_exception const& e) {
    g_last_error = e.msg;
    return e.code;
  } catch (std::exception const& e) {
    g_last_error = e.what();
    return ARB_INTERNAL;
  }
}

}  // namespace

extern "C" {

void* arbiter_create(char const* log_path) { return new task_arbiter(log_path); }

void arbiter_destroy(void* h) { delete static_cast<task_arbiter*>(h); }

char const* arbiter_last_error() { return g_last_error.c_str(); }

#define ARB static_cast<task_arbiter*>(h)

int arbiter_start_dedicated_task_thread(void* h, int64_t tid, int64_t task_id)
{
  return wrap(ARB, tid, [&] { ARB->start_dedicated_task_thread(tid, task_id); return ARB_OK; });
}

int arbiter_pool_thread_working_on_task(void* h, int64_t tid, int64_t task_id, int is_shuffle)
{
  return wrap(ARB, tid, [&] { ARB->pool_thread_working_on_task(tid, task_id, is_shuffle != 0); return ARB_OK; });
}

int arbiter_pool_thread_finished_for_task(void* h, int64_t tid, int64_t task_id)
{
  return wrap(ARB, tid, [&] { ARB->pool_thread_finished_for_task(tid, task_id); return ARB_OK; });
}

int arbiter_remove_thread_association(void* h, int64_t tid, int64_t task_id)
{
  return wrap(ARB, tid, [&] { ARB->remove_thread_association(tid, task_id); return ARB_OK; });
}

int arbiter_task_done(void* h, int64_t task_id)
{
  return wrap(ARB, -1, [&] { ARB->task_done(task_id); return ARB_OK; });
}

int arbiter_set_pool_blocked(void* h, int64_t tid, int blocked)
{
  return wrap(ARB, tid, [&] { ARB->set_pool_blocked(tid, blocked != 0); return ARB_OK; });
}

int arbiter_set_externally_blocked(void* h, int64_t tid, int blocked)
{
  return wrap(ARB, tid, [&] { ARB->set_externally_blocked(tid, blocked != 0); return ARB_OK; });
}

int arbiter_start_retry_block(void* h, int64_t tid)
{
  return wrap(ARB, tid, [&] { ARB->start_retry_block(tid); return ARB_OK; });
}

int arbiter_end_retry_block(void* h, int64_t tid)
{
  return wrap(ARB, tid, [&] { ARB->end_retry_block(tid); return ARB_OK; });
}

int arbiter_force_retry_oom(void* h, int64_t tid, int num, int filter, int skip)
{
  return wrap(ARB, tid, [&] { ARB->force_retry_oom(tid, num, filter, skip); return ARB_OK; });
}

int arbiter_force_split_and_retry_oom(void* h, int64_t tid, int num, int filter, int skip)
{
  return wrap(ARB, tid, [&] { ARB->force_split_and_retry_oom(tid, num, filter, skip); return ARB_OK; });
}

int arbiter_force_cudf_exception(void* h, int64_t tid, int num)
{
  return wrap(ARB, tid, [&] { ARB->force_cudf_exception(tid, num); return ARB_OK; });
}

int arbiter_pre_alloc(void* h, int64_t tid, int is_cpu, int blocking)
{
  return wrap(ARB, tid, [&] { return ARB->pre_alloc(tid, is_cpu != 0, blocking != 0); });
}

int arbiter_post_alloc_success(void* h, int64_t tid, int is_cpu, int was_recursive)
{
  return wrap(ARB, tid, [&] { ARB->post_alloc_success(tid, is_cpu != 0, was_recursive != 0); return ARB_OK; });
}

int arbiter_post_alloc_failed(void* h, int64_t tid, int is_cpu, int is_oom, int blocking,
                              int was_recursive)
{
  return wrap(ARB, tid, [&] {
    return ARB->post_alloc_failed(tid, is_cpu != 0, is_oom != 0, blocking != 0,
                                  was_recursive != 0)
             ? 1
             : 0;
  });
}

int arbiter_dealloc(void* h, int64_t tid, int is_cpu)
{
  return wrap(ARB, tid, [&] { ARB->dealloc(tid, is_cpu != 0); return ARB_OK; });
}

int arbiter_block_thread_until_ready(void* h, int64_t tid)
{
  return wrap(ARB, tid, [&] { return ARB->block_thread_until_ready(tid); });
}

int arbiter_check_and_break_deadlocks(void* h)
{
  return wrap(ARB, -1, [&] { ARB->check_and_break_deadlocks(); return ARB_OK; });
}

int arbiter_get_state_of(void* h, int64_t tid)
{
  return ARB->get_state_of(tid);
}

int64_t arbiter_get_and_reset_metric(void* h, int64_t task_id, int which)
{
  return ARB->get_and_reset_metric(task_id, which);
}

int64_t arbiter_get_total_blocked_or_bufn(void* h)
{
  return ARB->get_total_blocked_or_bufn();
}

}  // extern "C"
