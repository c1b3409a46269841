// JPEG codec on nvJPEG, for a machine that has the CUDA toolkit but not
// libjpeg's headers (src/imgdecode.cc needs them).  Host decoding for the
// image iterators, with src/imgdecode.cc's C ABI:
//
//   mxtpu_decode_jpeg_batch_alloc(bufs, lens, n, outs, ws, hs, nthreads)
//     decodes n JPEGs on nthreads host threads, each with its own nvJPEG
//     state, stream and device buffer; outs[i] receives a malloc'd RGB HWC
//     uint8 host buffer (freed by mxtpu_free_many) and ws/hs[i] its size,
//     or NULL and 0 where a buffer is not a 3-component JPEG nvJPEG
//     decodes.  Returns the count decoded.
//   mxtt_nvjpeg_encode(rgb, w, h, quality, out, len)
//     encodes one RGB HWC uint8 host image at 4:2:0 and `quality` into a
//     malloc'd buffer; 0 on success, else see mxtt_nvjpeg_error().
//
// This is not a kernel of the port: it computes nothing a TPU kernel of
// the JAX package computes, and nothing here is counted as a launch.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

std::once_flag g_once;
nvjpegHandle_t g_handle = nullptr;
std::mutex g_err_mu;
std::string g_err;
std::mutex g_enc_mu;

void set_error(const char* what, int code) {
  char msg[256];
  snprintf(msg, sizeof(msg), "%s failed with status %d", what, code);
  std::lock_guard<std::mutex> lock(g_err_mu);
  g_err = msg;
}

nvjpegHandle_t handle() {
  std::call_once(g_once, [] {
    nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      set_error("nvjpegCreateSimple", st);
      g_handle = nullptr;
    }
  });
  return g_handle;
}

// One decoding thread's resources.
struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dbuf = nullptr;
  size_t dcap = 0;

  bool init(nvjpegHandle_t h) {
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
        cudaSuccess) {
      set_error("cudaStreamCreate", 0);
      return false;
    }
    nvjpegStatus_t st = nvjpegJpegStateCreate(h, &state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      set_error("nvjpegJpegStateCreate", st);
      return false;
    }
    return true;
  }

  ~Worker() {
    if (state) nvjpegJpegStateDestroy(state);
    if (dbuf) cudaFree(dbuf);
    if (stream) cudaStreamDestroy(stream);
  }

  // Decode one JPEG into a malloc'd RGB HWC host buffer, or NULL.
  uint8_t* decode(nvjpegHandle_t h, const uint8_t* buf, size_t len, int* w,
                  int* hgt) {
    int ncomp = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    if (nvjpegGetImageInfo(h, buf, len, &ncomp, &sub, widths, heights) !=
            NVJPEG_STATUS_SUCCESS ||
        ncomp != 3 || widths[0] <= 0 || heights[0] <= 0) {
      return nullptr;
    }
    const size_t pitch = static_cast<size_t>(widths[0]) * 3;
    const size_t bytes = pitch * heights[0];
    if (bytes > dcap) {
      if (dbuf) cudaFree(dbuf);
      dbuf = nullptr;
      dcap = 0;
      if (cudaMalloc(&dbuf, bytes) != cudaSuccess) return nullptr;
      dcap = bytes;
    }
    nvjpegImage_t img;
    memset(&img, 0, sizeof(img));
    img.channel[0] = dbuf;
    img.pitch[0] = pitch;
    if (nvjpegDecode(h, state, buf, len, NVJPEG_OUTPUT_RGBI, &img, stream) !=
        NVJPEG_STATUS_SUCCESS) {
      cudaStreamSynchronize(stream);
      return nullptr;
    }
    uint8_t* out = static_cast<uint8_t*>(malloc(bytes));
    if (!out) {
      cudaStreamSynchronize(stream);
      return nullptr;
    }
    if (cudaMemcpyAsync(out, dbuf, bytes, cudaMemcpyDeviceToHost, stream) !=
            cudaSuccess ||
        cudaStreamSynchronize(stream) != cudaSuccess) {
      free(out);
      return nullptr;
    }
    *w = widths[0];
    *hgt = heights[0];
    return out;
  }
};

// Workers are kept for the life of the process and reused by later
// batches: a state's first decode allocates its buffers.
std::mutex g_pool_mu;
std::vector<Worker*> g_pool;

Worker* acquire(nvjpegHandle_t h) {
  {
    std::lock_guard<std::mutex> lock(g_pool_mu);
    if (!g_pool.empty()) {
      Worker* w = g_pool.back();
      g_pool.pop_back();
      return w;
    }
  }
  Worker* w = new Worker();
  if (!w->init(h)) {
    delete w;
    return nullptr;
  }
  return w;
}

void release(Worker* w) {
  std::lock_guard<std::mutex> lock(g_pool_mu);
  g_pool.push_back(w);
}

}  // namespace

extern "C" {

int mxtpu_decode_jpeg_batch_alloc(const uint8_t** bufs, const size_t* lens,
                                  int n, uint8_t** outs, int* ws, int* hs,
                                  int nthreads) {
  for (int i = 0; i < n; ++i) {
    outs[i] = nullptr;
    ws[i] = hs[i] = 0;
  }
  nvjpegHandle_t h = handle();
  if (!h || n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), ok(0);
  auto run = [&]() {
    Worker* wk = acquire(h);
    if (!wk) return;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, hgt = 0;
      uint8_t* out = wk->decode(h, bufs[i], lens[i], &w, &hgt);
      if (!out) continue;
      outs[i] = out;
      ws[i] = w;
      hs[i] = hgt;
      ok.fetch_add(1);
    }
    release(wk);
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(run);
  for (auto& th : pool) th.join();
  return ok.load();
}

void mxtpu_free_many(uint8_t** ptrs, int n) {
  for (int i = 0; i < n; ++i) {
    if (ptrs[i]) free(ptrs[i]);
    ptrs[i] = nullptr;
  }
}

int mxtt_nvjpeg_encode(const uint8_t* rgb, int w, int h, int quality,
                       uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  nvjpegHandle_t nh = handle();
  if (!nh) return -1;
  std::lock_guard<std::mutex> lock(g_enc_mu);
  cudaStream_t stream = nullptr;
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  unsigned char* dimg = nullptr;
  int rc = -1;
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  nvjpegImage_t src;
  memset(&src, 0, sizeof(src));
  nvjpegStatus_t st;
  size_t length = 0;
  uint8_t* buf = nullptr;
  if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) !=
      cudaSuccess) {
    set_error("cudaStreamCreate", 0);
    goto done;
  }
  if ((st = nvjpegEncoderStateCreate(nh, &state, stream)) !=
      NVJPEG_STATUS_SUCCESS) {
    set_error("nvjpegEncoderStateCreate", st);
    goto done;
  }
  if ((st = nvjpegEncoderParamsCreate(nh, &params, stream)) !=
      NVJPEG_STATUS_SUCCESS) {
    set_error("nvjpegEncoderParamsCreate", st);
    goto done;
  }
  if ((st = nvjpegEncoderParamsSetQuality(params, quality, stream)) !=
          NVJPEG_STATUS_SUCCESS ||
      (st = nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_420,
                                                  stream)) !=
          NVJPEG_STATUS_SUCCESS) {
    set_error("nvjpegEncoderParamsSet", st);
    goto done;
  }
  if (cudaMalloc(&dimg, bytes) != cudaSuccess ||
      cudaMemcpyAsync(dimg, rgb, bytes, cudaMemcpyHostToDevice, stream) !=
          cudaSuccess) {
    set_error("cudaMalloc/cudaMemcpy", 0);
    goto done;
  }
  src.channel[0] = dimg;
  src.pitch[0] = static_cast<size_t>(w) * 3;
  if ((st = nvjpegEncodeImage(nh, state, params, &src, NVJPEG_INPUT_RGBI, w,
                              h, stream)) != NVJPEG_STATUS_SUCCESS) {
    set_error("nvjpegEncodeImage", st);
    goto done;
  }
  if ((st = nvjpegEncodeRetrieveBitstream(nh, state, nullptr, &length,
                                          stream)) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(stream) != cudaSuccess) {
    set_error("nvjpegEncodeRetrieveBitstream (length)", st);
    goto done;
  }
  buf = static_cast<uint8_t*>(malloc(length));
  if (!buf) {
    set_error("malloc", 0);
    goto done;
  }
  if ((st = nvjpegEncodeRetrieveBitstream(nh, state, buf, &length,
                                          stream)) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(stream) != cudaSuccess) {
    set_error("nvjpegEncodeRetrieveBitstream", st);
    free(buf);
    goto done;
  }
  *out = buf;
  *out_len = length;
  rc = 0;
done:
  if (params) nvjpegEncoderParamsDestroy(params);
  if (state) nvjpegEncoderStateDestroy(state);
  if (dimg) cudaFree(dimg);
  if (stream) cudaStreamDestroy(stream);
  return rc;
}

const char* mxtt_nvjpeg_error() {
  static thread_local std::string copy;
  std::lock_guard<std::mutex> lock(g_err_mu);
  copy = g_err;
  return copy.c_str();
}

}  // extern "C"
