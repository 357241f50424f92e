// tario: the host data path of cosmos_tpu_torch's training loader.
//
// Two parts behind a plain C ABI, loaded with ctypes by
// cosmos_tpu_torch/data/native.py, which also builds this file with g++:
//
//   * a background-threaded tar shard streamer with a bounded sample queue
//     (prefetch hides file I/O behind augmentation);
//   * libjpeg decode with DCT-domain scaling (decode at 1/2, 1/4 or 1/8
//     resolution directly: the dominant cost of multi-crop augmentation is
//     decoding multi-megapixel JPEGs that are then resized to 224/96 px).
//
// The same functions, arguments and tar grouping rules as the JAX
// package's native/tario.cpp, so that both loaders give the same samples
// and the same decoded pixels.  The libjpeg 6.2 headers it compiles
// against are in jpeg/ beside it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decode with DCT scaling
// ---------------------------------------------------------------------------

struct tario_error_mgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void tario_error_exit(j_common_ptr cinfo) {
  tario_error_mgr* err = reinterpret_cast<tario_error_mgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB888.  scale_denom in {1,2,4,8} selects
// DCT-domain downscaling.  Returns a malloc'd buffer (caller frees via
// tario_free) or nullptr on corrupt input.
unsigned char* tario_decode_jpeg(const unsigned char* buf, long len,
                                 int scale_denom, int* out_w, int* out_h) {
  jpeg_decompress_struct cinfo;
  tario_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = tario_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom > 0 ? scale_denom : 1;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int stride = w * cinfo.output_components;
  unsigned char* out =
      static_cast<unsigned char*>(malloc(static_cast<size_t>(stride) * h));
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<size_t>(stride) * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (cinfo.output_components != 3) {  // grayscale etc: expand handled by caller
    // libjpeg already converted to RGB via out_color_space
  }
  *out_w = w;
  *out_h = h;
  return out;
}

// Probe (width, height) without a full decode.
int tario_jpeg_dims(const unsigned char* buf, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  tario_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = tario_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

void tario_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Threaded tar shard streamer
// ---------------------------------------------------------------------------

struct Member {
  std::string key;   // basename without extension
  std::string ext;   // lowercased extension
  std::vector<unsigned char> data;
};

struct Sample {
  std::string key;
  std::vector<Member> members;
};

struct Reader {
  std::vector<std::string> shards;
  size_t capacity;
  std::deque<Sample*> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> done{false};
  std::atomic<bool> stop{false};
  std::thread worker;
};

static size_t octal_field(const char* p, size_t n) {
  size_t v = 0;
  for (size_t i = 0; i < n && p[i] >= '0' && p[i] <= '7'; ++i)
    v = v * 8 + static_cast<size_t>(p[i] - '0');
  return v;
}

static void stream_shard(Reader* r, const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return;
  char hdr[512];
  Sample* cur = nullptr;
  std::string cur_key;
  auto flush = [&]() {
    if (!cur) return;
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_push.wait(lk, [&] { return r->queue.size() < r->capacity || r->stop; });
    if (r->stop) {
      delete cur;
      cur = nullptr;
      return;
    }
    r->queue.push_back(cur);
    cur = nullptr;
    r->cv_pop.notify_one();
  };
  while (!r->stop && fread(hdr, 1, 512, f) == 512) {
    if (hdr[0] == '\0') break;  // end-of-archive blocks
    size_t size = octal_field(hdr + 124, 12);
    char type = hdr[156];
    std::string name(hdr, strnlen(hdr, 100));
    // GNU long-name extension
    if (type == 'L') {
      std::vector<char> ln(size);
      if (fread(ln.data(), 1, size, f) != size) break;
      fseek(f, static_cast<long>((512 - size % 512) % 512), SEEK_CUR);
      if (fread(hdr, 1, 512, f) != 512) break;
      size = octal_field(hdr + 124, 12);
      type = hdr[156];
      name.assign(ln.data(), strnlen(ln.data(), ln.size()));
    }
    const size_t padded = (size + 511) / 512 * 512;
    if (type != '0' && type != '\0') {  // not a regular file
      fseek(f, static_cast<long>(padded), SEEK_CUR);
      continue;
    }
    // split at the first dot of the BASENAME (webdataset base_plus_ext;
    // must match data/webdataset.py tar_to_samples): './0001.jpg' or a
    // dotted directory like 'v1.2/0001.jpg' must not break key grouping
    const size_t slash = name.rfind('/');
    const size_t base = slash == std::string::npos ? 0 : slash + 1;
    const size_t dot = name.find('.', base);
    if (dot == std::string::npos) {
      fseek(f, static_cast<long>(padded), SEEK_CUR);
      continue;
    }
    Member m;
    m.key = name.substr(0, dot);
    m.ext = name.substr(dot + 1);
    for (auto& c : m.ext) c = static_cast<char>(tolower(c));
    m.data.resize(size);
    if (fread(m.data.data(), 1, size, f) != size) break;  // truncated
    fseek(f, static_cast<long>(padded - size), SEEK_CUR);
    // a repeated extension within the same key starts a NEW sample (the
    // Python path's nothrow regrouping: concatenated tars with repeated
    // keys must yield every pair, not overwrite the earlier members)
    bool dup_ext = false;
    if (cur && m.key == cur_key) {
      for (const auto& em : cur->members)
        if (em.ext == m.ext) { dup_ext = true; break; }
    }
    if (m.key != cur_key || dup_ext) {
      flush();
      if (r->stop) break;
      cur = new Sample();
      cur->key = m.key;
      cur_key = m.key;
    }
    if (cur) cur->members.push_back(std::move(m));
  }
  flush();
  fclose(f);
}

void* tario_open(const char** paths, int n_paths, int capacity) {
  Reader* r = new Reader();
  for (int i = 0; i < n_paths; ++i) r->shards.emplace_back(paths[i]);
  r->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 64;
  r->worker = std::thread([r] {
    for (const auto& s : r->shards) {
      if (r->stop) break;
      stream_shard(r, s);
    }
    r->done = true;
    std::lock_guard<std::mutex> lk(r->mu);
    r->cv_pop.notify_all();
  });
  return r;
}

// Pops one sample.  Returns the number of members (0 == stream finished).
// Member i's ext/data are fetched with tario_member; the sample stays
// owned by the library until tario_release_sample.
void* tario_next(void* handle, int* n_members) {
  Reader* r = static_cast<Reader*>(handle);
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_pop.wait(lk, [&] { return !r->queue.empty() || r->done || r->stop; });
  if (r->queue.empty()) {
    *n_members = 0;
    return nullptr;
  }
  Sample* s = r->queue.front();
  r->queue.pop_front();
  r->cv_push.notify_one();
  *n_members = static_cast<int>(s->members.size());
  return s;
}

const unsigned char* tario_member(void* sample, int idx, const char** ext,
                                  long* len) {
  Sample* s = static_cast<Sample*>(sample);
  Member& m = s->members[idx];
  *ext = m.ext.c_str();
  *len = static_cast<long>(m.data.size());
  return m.data.data();
}

const char* tario_sample_key(void* sample) {
  return static_cast<Sample*>(sample)->key.c_str();
}

void tario_release_sample(void* sample) { delete static_cast<Sample*>(sample); }

void tario_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  r->stop = true;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->cv_push.notify_all();
    r->cv_pop.notify_all();
  }
  if (r->worker.joinable()) r->worker.join();
  for (Sample* s : r->queue) delete s;
  delete r;
}

}  // extern "C"
