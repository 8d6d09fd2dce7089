// Native WAV decoder + threaded batch decode for the training data loader.
//
// A copy of the JAX package's decoder (ops/native/wav_decoder.cpp there), kept
// in the port so that it never reads that package: a small C++ library over a
// C ABI (ctypes on the Python side, no pybind11 dependency). Supports PCM
// 8/16/24/32-bit and IEEE float32 RIFF/WAVE.
//
// Build: ops/native/__init__.py runs g++ -O3 -fPIC -shared -std=c++17 -pthread
// at first use, into build/f5_tts_tpu_torch/libwav_decoder_<hash>.so.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  float* samples = nullptr;  // interleaved
  int64_t num_frames = 0;
  int32_t channels = 0;
  int32_t sample_rate = 0;
};

// Returns 0 on success, negative error code otherwise.
int decode_wav_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;

  uint8_t riff[12];
  if (std::fread(riff, 1, 12, f) != 12 || std::memcmp(riff, "RIFF", 4) != 0 ||
      std::memcmp(riff + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;
  }

  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;

  // size fields are untrusted: cap chunks at 2 GiB and validate fmt length
  constexpr uint32_t kMaxChunk = 2u << 30;

  uint8_t hdr[8];
  while (std::fread(hdr, 1, 8, f) == 8) {
    uint32_t size;
    std::memcpy(&size, hdr + 4, 4);
    if (size > kMaxChunk) {
      std::fclose(f);
      return -5;
    }
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      if (size < 16) {
        std::fclose(f);
        return -6;
      }
      std::vector<uint8_t> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != size) break;
      std::memcpy(&audio_format, fmt.data() + 0, 2);
      std::memcpy(&channels, fmt.data() + 2, 2);
      std::memcpy(&sample_rate, fmt.data() + 4, 4);
      std::memcpy(&bits, fmt.data() + 14, 2);
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data.resize(size);
      if (std::fread(data.data(), 1, size, f) != size) break;
      have_data = true;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
      continue;
    }
    if (size & 1) std::fseek(f, 1, SEEK_CUR);
  }
  std::fclose(f);

  if (!have_fmt || !have_data || channels == 0) return -3;

  int64_t n;
  float* buf;
  const uint8_t* p = data.data();

  if (audio_format == 3 && bits == 32) {  // IEEE float
    n = (int64_t)(data.size() / 4);
    buf = (float*)std::malloc(n * sizeof(float));
    std::memcpy(buf, p, n * sizeof(float));
  } else if ((audio_format == 1 || audio_format == 0xFFFE) && bits == 16) {
    n = (int64_t)(data.size() / 2);
    buf = (float*)std::malloc(n * sizeof(float));
    const int16_t* s = (const int16_t*)p;
    for (int64_t i = 0; i < n; ++i) buf[i] = s[i] / 32768.0f;
  } else if ((audio_format == 1 || audio_format == 0xFFFE) && bits == 32) {
    n = (int64_t)(data.size() / 4);
    buf = (float*)std::malloc(n * sizeof(float));
    const int32_t* s = (const int32_t*)p;
    for (int64_t i = 0; i < n; ++i) buf[i] = (float)(s[i] / 2147483648.0);
  } else if ((audio_format == 1 || audio_format == 0xFFFE) && bits == 24) {
    n = (int64_t)(data.size() / 3);
    buf = (float*)std::malloc(n * sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      buf[i] = (float)v / (float)(1 << 23);
    }
  } else if ((audio_format == 1 || audio_format == 0xFFFE) && bits == 8) {
    n = (int64_t)data.size();
    buf = (float*)std::malloc(n * sizeof(float));
    for (int64_t i = 0; i < n; ++i) buf[i] = ((float)p[i] - 128.0f) / 128.0f;
  } else {
    return -4;
  }

  out->samples = buf;
  out->num_frames = n / channels;
  out->channels = channels;
  out->sample_rate = (int32_t)sample_rate;
  return 0;
}

}  // namespace

extern "C" {

// Single-file decode. Caller frees *samples with f5_free.
int f5_wav_decode(const char* path, float** samples, int64_t* num_frames,
                  int32_t* channels, int32_t* sample_rate) {
  WavData w;
  int rc;
  try {
    rc = decode_wav_file(path, &w);
  } catch (...) {  // bad_alloc etc. must not unwind across the C ABI
    return -7;
  }
  if (rc != 0) return rc;
  *samples = w.samples;
  *num_frames = w.num_frames;
  *channels = w.channels;
  *sample_rate = w.sample_rate;
  return 0;
}

// Threaded batch decode: decodes `count` paths with `num_threads` workers.
// Per-file outputs mirror f5_wav_decode; failed files get num_frames = rc < 0.
int f5_wav_decode_batch(const char** paths, int32_t count, int32_t num_threads,
                        float** samples, int64_t* num_frames, int32_t* channels,
                        int32_t* sample_rates) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= count) return;
      WavData w;
      int rc;
      try {
        rc = decode_wav_file(paths[i], &w);
      } catch (...) {
        rc = -7;
      }
      if (rc == 0) {
        samples[i] = w.samples;
        num_frames[i] = w.num_frames;
        channels[i] = w.channels;
        sample_rates[i] = w.sample_rate;
      } else {
        samples[i] = nullptr;
        num_frames[i] = rc;
        channels[i] = 0;
        sample_rates[i] = 0;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

void f5_free(float* ptr) { std::free(ptr); }

}  // extern "C"
