// The native serving runner: runs an AOTInductor package of the serving program
// (evaluation/serving.py::export_serving_native, serving.native.pt2) with no
// Python in the process. The counterpart of the JAX package's
// native/pjrt_runner.cc, on libtorch's AOTIModelPackageLoader instead of a PJRT
// plugin; native/runner.py builds it (through ops/_build.py) and drives it.
//
// Two flavours from this one source: the CPU runner (CPU packages) and, built
// with -DFVT_RUNNER_CUDA against libtorch_cuda, the CUDA runner (CUDA
// packages). A CUDA package calls the hand kernels through the fvt::* ops, so
// the CUDA runner dlopens the op library (csrc/fvt_ops.cpp, --op-library)
// before it loads the package, and refuses to start without it.
//
// Usage (one-shot):
//   fvt_native_runner --package serving.native.pt2 [--op-library libfvt_ops.so]
//       --input u8:8,16,128,171,3:clips.bin [--input ...] --output out [--bench N]
// Writes one raw little-endian file per program output, out.0, out.1, ..., and
// prints a one-line JSON summary to stdout: the outputs (file, dtype, shape,
// bytes) and the op library's launch counts. --bench N: each input file holds
// N concatenated instances with distinct contents; after one warm-up, disjoint
// short and long batches give a two-point-slope time an execution by the host
// clock, and the CUDA runner the long batch's device time an execution by CUDA
// events on its execution stream (device_ms_per_exec; -1 on the CPU).
//
// Usage (daemon): load once, then serve requests line by line from stdin:
//   fvt_native_runner --package P --serve --serve-input u8:8,16,128,171,3
//       [--serve-input ...] --output out [--pipeline K]
// After loading it prints "ready" to stderr; each stdin line is whitespace-
// separated raw input file paths (one per --serve-input, in order); each
// request answers one JSON line on stdout, {"request": n, "outputs": [...],
// "launches": {...}} naming the output files (out.req<n>.<i>). A malformed
// request (wrong file count, a missing or short file) answers {"request": n,
// "error": "..."} and the daemon lives on; a failure of the program itself is
// fatal (exit 1).
//
// --pipeline K (serve mode): a stager thread reads and stages up to K requests
// ahead (on the CUDA runner: the copy to the card on a side stream, ordered
// before the execution by an event) while the current one executes. Replies
// stay in request order.

#include <ATen/ATen.h>
#include <dlfcn.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#ifdef FVT_RUNNER_CUDA
#include <c10/core/Event.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#endif

#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <condition_variable>
#include <deque>
#include <exception>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

[[noreturn]] void Die(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "fvt_native_runner: ");
  vfprintf(stderr, fmt, ap);
  fprintf(stderr, "\n");
  va_end(ap);
  exit(1);
}

double NowSec() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

struct DType {
  const char* name;
  at::ScalarType type;
};

constexpr DType kDTypes[] = {{"u8", at::kByte},      {"s32", at::kInt}, {"f32", at::kFloat},
                             {"bf16", at::kBFloat16}, {"s8", at::kChar}, {"pred", at::kBool}};

at::ScalarType ParseType(const std::string& s) {
  for (const DType& d : kDTypes)
    if (s == d.name) return d.type;
  Die("unsupported input dtype %s (u8|s32|f32|bf16|s8|pred)", s.c_str());
}

const char* TypeName(at::ScalarType t) {
  for (const DType& d : kDTypes)
    if (t == d.type) return d.name;
  return "other";
}

struct InputSpec {
  at::ScalarType type;
  std::vector<int64_t> dims;
  size_t instance_bytes;
};

// "u8:8,16,128,171,3" -> a shape (serve mode).
InputSpec ParseShape(const std::string& spec) {
  const size_t c1 = spec.find(':');
  if (c1 == std::string::npos) Die("bad input spec %s (want dtype:d0,d1,...)", spec.c_str());
  InputSpec in;
  in.type = ParseType(spec.substr(0, c1));
  const std::string dims = spec.substr(c1 + 1);
  size_t pos = 0, n = 1;
  while (pos < dims.size()) {
    size_t comma = dims.find(',', pos);
    if (comma == std::string::npos) comma = dims.size();
    const long long d = atoll(dims.substr(pos, comma - pos).c_str());
    if (d <= 0) Die("bad dimension in %s", spec.c_str());
    in.dims.push_back(d);
    n *= static_cast<size_t>(d);
    pos = comma + 1;
  }
  if (in.dims.empty()) Die("bad input spec %s (no dimensions)", spec.c_str());
  in.instance_bytes = n * c10::elementSize(in.type);
  return in;
}

// The file's size, or -1 where it cannot be opened.
long FileSize(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  fclose(f);
  return n;
}

bool ReadInto(const std::string& path, void* dst, size_t bytes, size_t offset = 0) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, static_cast<long>(offset), SEEK_SET);
  const bool ok = !bytes || fread(dst, 1, bytes, f) == bytes;
  fclose(f);
  return ok;
}

// The op library's launch counts (fvt_ops_counter_names / _launch_counts).
struct OpLibrary {
  const char* (*names)() = nullptr;
  int (*counts)(long long*, int) = nullptr;

  void Load(const std::string& path) {
    // global: the package's proxy executor finds the ops in the dispatcher,
    // which the library's static registrars fill when it is loaded
    void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_GLOBAL);
    if (!handle) Die("dlopen(%s): %s", path.c_str(), dlerror());
    names = reinterpret_cast<const char* (*)()>(dlsym(handle, "fvt_ops_counter_names"));
    counts = reinterpret_cast<int (*)(long long*, int)>(dlsym(handle, "fvt_ops_launch_counts"));
    if (!names || !counts) Die("%s is not the fvt op library (no launch counters)", path.c_str());
  }

  // ", \"launches\": {...}" (null without the library)
  std::string Json() const {
    if (!counts) return ", \"launches\": null";
    long long v[16];
    const int n = counts(v, 16);
    std::string out = ", \"launches\": {";
    std::string all = names();
    size_t pos = 0;
    for (int i = 0; i < n && i < 16; ++i) {
      size_t comma = all.find(',', pos);
      if (comma == std::string::npos) comma = all.size();
      out += (i ? ", \"" : "\"") + all.substr(pos, comma - pos) + "\": " + std::to_string(v[i]);
      pos = comma + 1;
    }
    return out + "}";
  }
};

// Where the package runs: the CPU, or the card on one execution stream, with
// a side stream for the stager.
struct Device {
  at::Device device = at::kCPU;
#ifdef FVT_RUNNER_CUDA
  std::unique_ptr<c10::cuda::CUDAStream> exec, side;
#endif

  void* StreamHandle() {
#ifdef FVT_RUNNER_CUDA
    if (exec) return exec->stream();
#endif
    return nullptr;
  }

  void Synchronize() {
#ifdef FVT_RUNNER_CUDA
    if (exec) exec->synchronize();
#endif
  }

  // A copy of t on the host, made on the execution stream (so after the
  // execution that wrote t); it returns when the copy is done.
  at::Tensor ToHost(const at::Tensor& t) {
#ifdef FVT_RUNNER_CUDA
    if (exec) {
      const c10::cuda::CUDAStreamGuard guard(*exec);
      return t.to(at::kCPU).contiguous();
    }
#endif
    return t.contiguous();
  }
};

// Device time between two points of the execution stream, by CUDA events
// (the CUDA runner; nothing on the CPU).
struct Timer {
#ifdef FVT_RUNNER_CUDA
  cudaEvent_t start = nullptr, stop = nullptr;
#endif

  void Start(Device& dev) {
#ifdef FVT_RUNNER_CUDA
    if (!dev.exec) return;
    if (!start && (cudaEventCreate(&start) != cudaSuccess || cudaEventCreate(&stop) != cudaSuccess))
      Die("cudaEventCreate failed");
    cudaEventRecord(start, dev.exec->stream());
#endif
    (void)dev;
  }

  // ms since Start, the stream synchronized; -1 on the CPU
  double StopMs(Device& dev) {
#ifdef FVT_RUNNER_CUDA
    if (!dev.exec) return -1.0;
    cudaEventRecord(stop, dev.exec->stream());
    float ms = 0.0f;
    if (cudaEventSynchronize(stop) != cudaSuccess || cudaEventElapsedTime(&ms, start, stop) != cudaSuccess)
      Die("CUDA event timing failed");
    return ms;
#endif
    (void)dev;
    return -1.0;
  }
};

// One staged argument list: the tensors on the package's device, and (on the
// card) the event that orders their copy before the execution.
struct Staged {
  std::vector<at::Tensor> host, args;
#ifdef FVT_RUNNER_CUDA
  std::shared_ptr<c10::Event> ready;
#endif
};

// Reads one instance of each input (file i at offsets[i]) and stages it on the
// device: on the card into pinned memory, then an asynchronous copy on
// `side` (the execution stream where null). False where a file is short.
bool Stage(Device& dev, const std::vector<InputSpec>& specs, const std::vector<std::string>& paths,
           const std::vector<size_t>& offsets, bool side, Staged* out) {
  const bool on_card = dev.device.is_cuda();
  for (size_t i = 0; i < specs.size(); ++i) {
    at::Tensor host = at::empty(specs[i].dims, at::TensorOptions()
                                                   .dtype(specs[i].type)
                                                   .pinned_memory(on_card));
    if (!ReadInto(paths[i], host.data_ptr(), specs[i].instance_bytes, offsets[i])) return false;
    out->host.push_back(host);
  }
#ifdef FVT_RUNNER_CUDA
  if (on_card) {
    c10::cuda::CUDAStream stream = side ? *dev.side : *dev.exec;
    const c10::cuda::CUDAStreamGuard guard(stream);
    for (const at::Tensor& h : out->host) out->args.push_back(h.to(dev.device, true));
    if (side) {
      out->ready = std::make_shared<c10::Event>(c10::DeviceType::CUDA);
      out->ready->record(stream);
    }
    return true;
  }
#endif
  out->args = out->host;
  return true;
}

std::vector<at::Tensor> Execute(torch::inductor::AOTIModelPackageLoader& loader, Device& dev,
                                Staged& in) {
#ifdef FVT_RUNNER_CUDA
  if (dev.exec) {
    const c10::cuda::CUDAStreamGuard guard(*dev.exec);
    if (in.ready) {
      in.ready->block(*dev.exec);
      // the inputs were allocated on the side stream: keep their memory
      // until the execution stream is done with them
      for (at::Tensor& a : in.args) a.record_stream(*dev.exec);
    }
    return loader.run(in.args, dev.StreamHandle());
  }
#endif
  return loader.run(in.args, nullptr);
}

// Copies each output to the host, writes <prefix>.<i> and returns the JSON
// array that names them.
std::string WriteOutputs(Device& dev, const std::vector<at::Tensor>& outs,
                         const std::string& prefix) {
  std::string json = "[";
  for (size_t i = 0; i < outs.size(); ++i) {
    const at::Tensor host = dev.ToHost(outs[i]);
    const std::string path = prefix + "." + std::to_string(i);
    FILE* f = fopen(path.c_str(), "wb");
    if (!f) Die("cannot write %s", path.c_str());
    const size_t bytes = host.nbytes();
    if (bytes && fwrite(host.data_ptr(), 1, bytes, f) != bytes) Die("short write: %s", path.c_str());
    fclose(f);
    json += std::string(i ? ", " : "") + "{\"file\": \"" + path + "\", \"dtype\": \"" +
            TypeName(host.scalar_type()) + "\", \"shape\": [";
    for (int64_t d = 0; d < host.dim(); ++d)
      json += std::string(d ? ", " : "") + std::to_string(host.size(d));
    json += "], \"bytes\": " + std::to_string(bytes) + "}";
  }
  return json + "]";
}

bool IsBlank(const char* line) {
  for (const char* p = line; *p; ++p)
    if (!strchr(" \t\r\n", *p)) return false;
  return true;
}

struct Request {
  size_t id = 0;
  Staged staged;
  std::string error;  // non-empty: a soft validation failure
};

int Run(int argc, char** argv) {
  std::string package, op_library, out_prefix = "out";
  size_t bench_n = 1;
  long pipeline = 0;
  bool serve = false;
  std::vector<std::string> input_specs, serve_specs;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (++i >= argc) Die("missing value for %s", a.c_str());
      return argv[i];
    };
    if (a == "--package") package = next();
    else if (a == "--op-library") op_library = next();
    else if (a == "--input") input_specs.push_back(next());
    else if (a == "--output") out_prefix = next();
    else if (a == "--bench") {
      bench_n = static_cast<size_t>(atoll(next().c_str()));
      // 1 warm-up + disjoint short / long batches with n_long > n_short
      if (bench_n < 1 || (bench_n > 1 && bench_n < 6))
        Die("--bench needs >= 6 instances (1 warm-up + short/long batches with a "
            "meaningful slope); got %zu", bench_n);
    } else if (a == "--serve") serve = true;
    else if (a == "--serve-input") serve_specs.push_back(next());
    else if (a == "--pipeline") {
      pipeline = atol(next().c_str());
      if (pipeline < 0) Die("--pipeline must be >= 0 (got %ld)", pipeline);
    } else if (a == "--help") {
      printf("usage: fvt_native_runner --package P.pt2 [--op-library libfvt_ops.so] "
             "[--input dtype:dims:file]... [--output prefix] [--bench N]\n"
             "--op-library: the fvt::* ops (csrc/fvt_ops.cpp), loaded before the package; "
             "the CUDA runner needs it.\n"
             "--bench N: each input file holds N concatenated instances with DISTINCT "
             "contents; reports the two-point-slope time an execution over disjoint "
             "short/long batches.\n"
             "--serve: load once, then read one request per stdin line (whitespace-"
             "separated raw input files, one per --serve-input dtype:dims spec, in "
             "order); answers one JSON line each.\n"
             "--pipeline K: in serve mode, stage up to K requests ahead on a thread so "
             "that the copy to the device overlaps execution (replies stay ordered).\n");
      return 0;
    } else Die("unknown arg %s", a.c_str());
  }
  if (package.empty()) Die("--package is required (see --help)");
  if (serve && (bench_n > 1 || !input_specs.empty()))
    Die("--serve takes --serve-input specs, not --input/--bench");
  if (serve && serve_specs.empty())
    Die("--serve needs at least one --serve-input dtype:d0,d1,... spec");
  if (pipeline > 0 && !serve) Die("--pipeline only applies to --serve");
  if (!serve && input_specs.empty()) Die("one-shot mode needs --input dtype:dims:file specs");

  Device dev;
  OpLibrary ops;
#ifdef FVT_RUNNER_CUDA
  if (op_library.empty())
    Die("the CUDA runner needs --op-library (the fvt::* ops of csrc/fvt_ops.cpp): a CUDA "
        "package calls the hand kernels through them");
  dev.device = at::Device(at::kCUDA, 0);
#endif
  if (!op_library.empty()) ops.Load(op_library);

  // one-shot inputs: the spec and file of each, checked before the load
  std::vector<InputSpec> specs;
  std::vector<std::string> files;
  for (const std::string& spec : input_specs) {
    const size_t c2 = spec.rfind(':');
    if (c2 == std::string::npos || spec.find(':') == c2)
      Die("bad --input %s (want dtype:d0,d1,...:file)", spec.c_str());
    specs.push_back(ParseShape(spec.substr(0, c2)));
    files.push_back(spec.substr(c2 + 1));
    const long size = FileSize(files.back());
    if (size < 0) Die("cannot open %s", files.back().c_str());
    if (static_cast<size_t>(size) != specs.back().instance_bytes * bench_n)
      Die("input file size %ld != expected %zu (x%zu instances) for %s", size,
          specs.back().instance_bytes, bench_n, spec.c_str());
  }
  for (const std::string& s : serve_specs) specs.push_back(ParseShape(s));

  // two model instances: one run enqueues while the previous one executes
  torch::inductor::AOTIModelPackageLoader loader(package, "model", false, 2,
                                                 dev.device.is_cuda() ? 0 : -1);
  const auto meta = loader.get_metadata();
  const auto key = meta.find("AOTI_DEVICE_KEY");
  const std::string pkg_device = key == meta.end() ? "?" : key->second;
  if (pkg_device != (dev.device.is_cuda() ? "cuda" : "cpu"))
    Die("%s is a %s package; this is the %s runner", package.c_str(), pkg_device.c_str(),
        dev.device.is_cuda() ? "CUDA" : "CPU");
#ifdef FVT_RUNNER_CUDA
  dev.exec = std::make_unique<c10::cuda::CUDAStream>(c10::cuda::getStreamFromPool(false, 0));
  dev.side = std::make_unique<c10::cuda::CUDAStream>(c10::cuda::getStreamFromPool(false, 0));
#endif

  if (serve) {
    auto stage_request = [&](char* line, size_t id) -> Request {
      Request req;
      req.id = id;
      std::vector<std::string> paths;
      char* save = nullptr;
      for (char* tok = strtok_r(line, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save))
        paths.push_back(tok);
      char msg[512];
      if (paths.size() != specs.size()) {
        snprintf(msg, sizeof(msg), "want %zu input files, got %zu", specs.size(), paths.size());
        req.error = msg;
        return req;
      }
      for (size_t i = 0; i < specs.size(); ++i) {
        const long size = FileSize(paths[i]);
        if (size < 0) {
          snprintf(msg, sizeof(msg), "cannot read input %zu", i);
          req.error = msg;
          return req;
        }
        if (static_cast<size_t>(size) != specs[i].instance_bytes) {
          snprintf(msg, sizeof(msg), "input %zu holds %ld bytes, spec wants %zu", i, size,
                   specs[i].instance_bytes);
          req.error = msg;
          return req;
        }
      }
      if (!Stage(dev, specs, paths, std::vector<size_t>(specs.size(), 0), pipeline > 0,
                 &req.staged)) {
        req.staged = Staged();
        req.error = "short read of an input";
      }
      return req;
    };

    auto serve_request = [&](Request& req) {
      if (!req.error.empty()) {
        printf("{\"request\": %zu, \"error\": \"%s\"}\n", req.id, req.error.c_str());
      } else {
        const std::vector<at::Tensor> outs = Execute(loader, dev, req.staged);
        const std::string prefix = out_prefix + ".req" + std::to_string(req.id);
        const std::string json = WriteOutputs(dev, outs, prefix);
        printf("{\"request\": %zu, \"outputs\": %s%s}\n", req.id, json.c_str(),
               ops.Json().c_str());
      }
      fflush(stdout);
    };

    fprintf(stderr, "ready\n");
    fflush(stderr);
    if (pipeline == 0) {
      char* line = nullptr;
      size_t cap = 0, req_id = 0;
      while (getline(&line, &cap, stdin) != -1) {
        if (IsBlank(line)) continue;
        Request req = stage_request(line, req_id++);
        serve_request(req);
      }
      free(line);
    } else {
      // The stager reads and stages request N+k while the main thread
      // executes N. The bounded FIFO caps the staged requests at `pipeline`
      // (+1 executing), and errors go through it too, so replies stay in
      // request order.
      std::deque<Request> q;
      std::mutex mu;
      std::condition_variable cv_push, cv_pop;
      bool done = false;
      std::exception_ptr failed;
      std::thread stager([&] {
        try {
#ifdef FVT_RUNNER_CUDA
          const c10::cuda::CUDAGuard guard(dev.device);
#endif
          char* line = nullptr;
          size_t cap = 0, req_id = 0;
          while (getline(&line, &cap, stdin) != -1) {
            if (IsBlank(line)) continue;
            Request req = stage_request(line, req_id++);
            std::unique_lock<std::mutex> lk(mu);
            cv_pop.wait(lk, [&] { return q.size() < static_cast<size_t>(pipeline); });
            q.push_back(std::move(req));
            cv_push.notify_one();
          }
          free(line);
        } catch (...) {
          failed = std::current_exception();
        }
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv_push.notify_one();
      });
      for (;;) {
        Request req;
        {
          std::unique_lock<std::mutex> lk(mu);
          cv_push.wait(lk, [&] { return !q.empty() || done; });
          if (q.empty()) break;
          req = std::move(q.front());
          q.pop_front();
          cv_pop.notify_one();
        }
        serve_request(req);
      }
      stager.join();
      if (failed) std::rethrow_exception(failed);
    }
    dev.Synchronize();
    return 0;
  }

  // One-shot: instance i of every input staged up front (distinct contents).
  std::vector<Staged> sets(bench_n);
  for (size_t inst = 0; inst < bench_n; ++inst) {
    std::vector<size_t> offsets;
    for (const InputSpec& s : specs) offsets.push_back(inst * s.instance_bytes);
    if (!Stage(dev, specs, files, offsets, false, &sets[inst])) Die("short read of an input");
  }
  std::vector<at::Tensor> outputs;
  double sec_per_exec = -1.0, t_short = 0.0, t_long = 0.0, device_ms = -1.0;
  size_t n_short = 0, n_long = 0;
  // a host copy of output 0 on the execution stream: the executions before
  // it are done when it returns
  auto readback = [&](const std::vector<at::Tensor>& outs) { dev.ToHost(outs[0]); };
  if (bench_n <= 1) {
    outputs = Execute(loader, dev, sets[0]);
  } else {
    outputs = Execute(loader, dev, sets[0]);  // warm-up
    readback(outputs);
    const size_t avail = bench_n - 1;
    n_short = avail / 4 > 0 ? avail / 4 : 1;
    n_long = avail - n_short;
    if (n_long <= n_short)
      Die("internal: bench batch split degenerate (n_short=%zu n_long=%zu)", n_short, n_long);
    Timer timer;
    auto run_batch = [&](size_t lo, size_t hi) {
      const double t0 = NowSec();
      for (size_t i = lo; i < hi; ++i) outputs = Execute(loader, dev, sets[i]);
      readback(outputs);
      return NowSec() - t0;
    };
    t_short = run_batch(1, 1 + n_short);
    timer.Start(dev);
    t_long = run_batch(1 + n_short, 1 + n_short + n_long);
    const double long_ms = timer.StopMs(dev);
    if (long_ms >= 0.0) device_ms = long_ms / static_cast<double>(n_long);
    sec_per_exec = (t_long - t_short) / static_cast<double>(n_long - n_short);
  }
  dev.Synchronize();
  const std::string json = WriteOutputs(dev, outputs, out_prefix);
  if (sec_per_exec > 0.0)
    printf("{\"bench\": {\"n_short\": %zu, \"n_long\": %zu, \"t_short_s\": %.6f, "
           "\"t_long_s\": %.6f, \"sec_per_exec\": %.6f, \"device_ms_per_exec\": %.6f}, "
           "\"outputs\": %s%s}\n",
           n_short, n_long, t_short, t_long, sec_per_exec, device_ms, json.c_str(),
           ops.Json().c_str());
  else
    printf("{\"outputs\": %s%s}\n", json.c_str(), ops.Json().c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {
    Die("%s", e.what());
  }
}
