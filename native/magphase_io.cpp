// magphase_io: native corpus-IO runtime for magphase_jax.
//
// The reference's native layer (REAPER/SPTK) moved on-device; what remains
// host-side at corpus scale is IO: WAV decode, raw float32 feature files,
// and padded batch assembly.  This library does those with mmap-free
// buffered reads and a std::thread fan-out, exposed through a C ABI for
// ctypes (no pybind11 in this environment).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode (PCM 16/24/32, IEEE float32/64) -> float32 in [-1, 1)

// returns n_samples (first channel) or -1 on error; *fs_out = sample rate
int64_t mp_read_wav(const char* path, float* out, int64_t max_len,
                    int32_t* fs_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) ||
      std::memcmp(hdr + 8, "WAVE", 4)) {
    std::fclose(f);
    return -1;
  }
  uint16_t afmt = 0, n_ch = 0, bits = 0;
  uint32_t fs = 0;
  std::vector<uint8_t> data;
  while (true) {
    char cid[4];
    uint32_t csz;
    if (std::fread(cid, 1, 4, f) != 4 || std::fread(&csz, 4, 1, f) != 1)
      break;
    if (!std::memcmp(cid, "fmt ", 4)) {
      std::vector<uint8_t> body(csz);
      if (std::fread(body.data(), 1, csz, f) != csz) break;
      afmt = *(uint16_t*)&body[0];
      n_ch = *(uint16_t*)&body[2];
      fs = *(uint32_t*)&body[4];
      bits = *(uint16_t*)&body[14];
      if (afmt == 0xFFFE && csz >= 26) afmt = *(uint16_t*)&body[24];
    } else if (!std::memcmp(cid, "data", 4)) {
      data.resize(csz);
      if (std::fread(data.data(), 1, csz, f) != csz) data.resize(0);
      break;
    } else {
      std::fseek(f, csz + (csz & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (data.empty() || n_ch == 0) return -1;
  *fs_out = (int32_t)fs;

  int64_t n = 0;
  const int64_t stride = n_ch;
  if (afmt == 1 && bits == 16) {
    const int16_t* p = (const int16_t*)data.data();
    int64_t total = (int64_t)(data.size() / 2) / stride;
    n = total < max_len ? total : max_len;
    for (int64_t i = 0; i < n; i++) out[i] = p[i * stride] / 32768.0f;
  } else if (afmt == 1 && bits == 24) {
    const uint8_t* p = data.data();
    int64_t total = (int64_t)(data.size() / 3) / stride;
    n = total < max_len ? total : max_len;
    for (int64_t i = 0; i < n; i++) {
      const uint8_t* b = p + 3 * i * stride;
      int32_t v = (int32_t)(b[0] | (b[1] << 8) | (b[2] << 16));
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = v / 8388608.0f;
    }
  } else if (afmt == 1 && bits == 32) {
    const int32_t* p = (const int32_t*)data.data();
    int64_t total = (int64_t)(data.size() / 4) / stride;
    n = total < max_len ? total : max_len;
    for (int64_t i = 0; i < n; i++) out[i] = p[i * stride] / 2147483648.0f;
  } else if (afmt == 3 && bits == 32) {
    const float* p = (const float*)data.data();
    int64_t total = (int64_t)(data.size() / 4) / stride;
    n = total < max_len ? total : max_len;
    for (int64_t i = 0; i < n; i++) out[i] = p[i * stride];
  } else if (afmt == 3 && bits == 64) {
    const double* p = (const double*)data.data();
    int64_t total = (int64_t)(data.size() / 8) / stride;
    n = total < max_len ? total : max_len;
    for (int64_t i = 0; i < n; i++) out[i] = (float)p[i * stride];
  } else {
    return -1;
  }
  return n;
}

// write PCM16 WAV; returns 0 on success
int32_t mp_write_wav(const char* path, const float* sig, int64_t n,
                     int32_t fs) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t data_sz = (uint32_t)(n * 2);
  uint32_t riff_sz = 36 + data_sz;
  uint32_t byte_rate = fs * 2;
  uint16_t block = 2, bits = 16, afmt = 1, n_ch = 1;
  uint32_t fmt_sz = 16;
  std::fwrite("RIFF", 1, 4, f);
  std::fwrite(&riff_sz, 4, 1, f);
  std::fwrite("WAVE", 1, 4, f);
  std::fwrite("fmt ", 1, 4, f);
  std::fwrite(&fmt_sz, 4, 1, f);
  std::fwrite(&afmt, 2, 1, f);
  std::fwrite(&n_ch, 2, 1, f);
  std::fwrite(&fs, 4, 1, f);
  std::fwrite(&byte_rate, 4, 1, f);
  std::fwrite(&block, 2, 1, f);
  std::fwrite(&bits, 2, 1, f);
  std::fwrite("data", 1, 4, f);
  std::fwrite(&data_sz, 4, 1, f);
  std::vector<int16_t> buf(n);
  for (int64_t i = 0; i < n; i++) {
    float v = sig[i] * 32768.0f;
    v = v > 32767.0f ? 32767.0f : (v < -32768.0f ? -32768.0f : v);
    buf[i] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
  }
  std::fwrite(buf.data(), 2, n, f);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// raw float32 feature files (libutils.py:112-127 byte format)

int64_t mp_read_binfile(const char* path, float* out, int64_t max_floats) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t n = (int64_t)std::fread(out, 4, max_floats, f);
  std::fclose(f);
  return n;
}

int32_t mp_write_binfile(const char* path, const float* data, int64_t n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fwrite(data, 4, n, f);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// threaded padded batch assembly

// paths: B concatenated NUL-terminated strings.  out: (B, max_len) float32,
// zero-padded.  lens/fss: per-utterance outputs.  Returns 0 if all loaded.
int32_t mp_batch_read_wavs(const char* paths, int32_t B, float* out,
                           int64_t max_len, int64_t* lens, int32_t* fss,
                           int32_t n_threads) {
  std::vector<const char*> ps(B);
  const char* p = paths;
  for (int32_t i = 0; i < B; i++) {
    ps[i] = p;
    p += std::strlen(p) + 1;
  }
  std::vector<int32_t> err(B, 0);
  auto work = [&](int32_t t0, int32_t step) {
    for (int32_t i = t0; i < B; i += step) {
      float* dst = out + (int64_t)i * max_len;
      std::memset(dst, 0, max_len * 4);
      int32_t fs = 0;
      int64_t n = mp_read_wav(ps[i], dst, max_len, &fs);
      lens[i] = n;
      fss[i] = fs;
      if (n < 0) err[i] = 1;
    }
  };
  if (n_threads <= 1) {
    work(0, 1);
  } else {
    std::vector<std::thread> th;
    for (int32_t t = 0; t < n_threads; t++) th.emplace_back(work, t, n_threads);
    for (auto& t : th) t.join();
  }
  for (int32_t i = 0; i < B; i++)
    if (err[i]) return -1;
  return 0;
}

}  // extern "C"
