// tile_reader: native host runtime for the WSI tile input pipeline.
//
// The port's own copy of the reference package's runtime/tile_reader.cc:
// the code is the same, only these comments name the port's files.  Built
// with g++ at first use by io/native.py (flags of the reference's Makefile)
// into the port's git-ignored _build/ directory.
//
// The reference feeds its detector through Python DataLoader workers doing
// PIL decode + torch interpolate per tile (utils/datasets.py:40-62,
// detect.py:71-77).  The input pipeline must keep a much faster device
// fed, so decode + downsample run natively:
//
//   * libjpeg decode with DCT-domain scaling (jpeg_core scale_num/denom):
//     decoding a 1536x1536 JPEG directly at 1/2 scale cuts IDCT + color
//     conversion work ~4x before we ever touch the pixels;
//   * nearest-index gather to the model input size (the exact
//     floor(dst*in/out) indices of torch F.interpolate(mode="nearest"),
//     computed against the ORIGINAL tile size so results are bit-identical
//     to the Python/JAX path whenever the scaled decode lands on an
//     integer divisor of the requested indices — for 1536->416 we decode
//     full-size by default and gather, keeping parity exact);
//   * a pthread worker pool with a simple work queue, filling caller-owned
//     uint8 batch buffers (NHWC) that Python hands straight to the
//     device copy.
//
// Exposed as a tiny C ABI consumed via ctypes (io/native.py of the port).

#include <cstddef>  // size_t before jpeglib.h (its header assumes stdio.h)
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file into an RGB buffer (caller-sized). Returns 0 on
// success. If the decoded image is smaller than (h, w), the remainder is
// zero-filled (WSI border tiles); larger images are cropped. When src_h /
// src_w are non-null they receive the decoded (pre-crop) dimensions so the
// caller can detect non-standard tiles.
int decode_jpeg_into(const char* path, uint8_t* out, int out_h, int out_w,
                     int scale_num, int scale_denom,
                     int* src_h = nullptr, int* src_w = nullptr) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // Declared BEFORE setjmp (libjpeg's recommended structure): a longjmp
  // from inside the scanline loop must not skip this vector's destructor —
  // each corrupt body would otherwise leak ~width*3 heap bytes.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);

  const int w = static_cast<int>(cinfo.output_width);
  // report PRE-scale dimensions: callers key border-tile handling and
  // coordinate spaces off the original image geometry
  if (src_h) *src_h = static_cast<int>(cinfo.image_height);
  if (src_w) *src_w = static_cast<int>(cinfo.image_width);
  row.resize(static_cast<size_t>(w) * 3);
  std::memset(out, 0, static_cast<size_t>(out_h) * out_w * 3);
  const int copy_w = w < out_w ? w : out_w;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = row.data();
    int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rp, 1);
    if (y < out_h) {
      std::memcpy(out + (static_cast<size_t>(y) * out_w) * 3, row.data(),
                  static_cast<size_t>(copy_w) * 3);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// In-memory variant (HTTP request bodies, serving.py): same semantics as
// decode_jpeg_into but sourced from a caller buffer via jpeg_mem_src.
// When require_h/require_w > 0, returns 3 right after the header if the
// source dimensions differ — the serving fast path uses this to reject
// non-tile-sized images for ~free (no scanline work) and fall back to the
// general pad_to_square path.
int decode_jpeg_mem_into(const uint8_t* buf, unsigned long len, uint8_t* out,
                         int out_h, int out_w, int scale_num, int scale_denom,
                         int* src_h = nullptr, int* src_w = nullptr,
                         int require_h = 0, int require_w = 0) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // Before setjmp: this decoder is network-facing (POST /v1/detect), and a
  // longjmp over the vector's scope would leak heap per corrupt request.
  std::vector<uint8_t> row;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  if (src_h) *src_h = static_cast<int>(cinfo.image_height);
  if (src_w) *src_w = static_cast<int>(cinfo.image_width);
  if ((require_h && static_cast<int>(cinfo.image_height) != require_h) ||
      (require_w && static_cast<int>(cinfo.image_width) != require_w)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);

  const int w = static_cast<int>(cinfo.output_width);
  row.resize(static_cast<size_t>(w) * 3);
  std::memset(out, 0, static_cast<size_t>(out_h) * out_w * 3);
  const int copy_w = w < out_w ? w : out_w;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = row.data();
    int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, &rp, 1);
    if (y < out_h) {
      std::memcpy(out + (static_cast<size_t>(y) * out_w) * 3, row.data(),
                  static_cast<size_t>(copy_w) * 3);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// nearest gather: src (src_h, src_w, 3) -> dst (dst, dst, 3) using
// floor(i * src/dst) indices (torch/JAX nearest parity).
void nearest_resize(const uint8_t* src, int src_h, int src_w, uint8_t* dst,
                    int dst_size) {
  std::vector<int> xi(dst_size), yi(dst_size);
  for (int i = 0; i < dst_size; ++i) {
    int ix = static_cast<int>(static_cast<double>(i) * src_w / dst_size);
    int iy = static_cast<int>(static_cast<double>(i) * src_h / dst_size);
    xi[i] = ix < src_w ? ix : src_w - 1;
    yi[i] = iy < src_h ? iy : src_h - 1;
  }
  for (int y = 0; y < dst_size; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(yi[y]) * src_w * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * dst_size * 3;
    for (int x = 0; x < dst_size; ++x) {
      std::memcpy(drow + x * 3, srow + xi[x] * 3, 3);
    }
  }
}

struct Job {
  const char* path;
  uint8_t* out;     // slot in the batch buffer
  int tile_size;
  int resize_to;    // 0 = keep tile_size
  int scale_denom;  // libjpeg DCT-domain decode scale (1 = full)
  int* status;
  int* dims;        // 2 ints (h, w) of the ORIGINAL source, or nullptr
};

class Pool {
 public:
  explicit Pool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      threads_.emplace_back([this] { worker(); });
    }
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void submit(Job j) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(j);
      ++outstanding_;
    }
    cv_.notify_one();
  }
  void wait_all() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return outstanding_ == 0; });
  }

 private:
  void worker() {
    std::vector<uint8_t> scratch;
    for (;;) {
      Job j;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        j = jobs_.front();
        jobs_.pop();
      }
      run(j, scratch);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--outstanding_ == 0) done_cv_.notify_all();
      }
    }
  }
  void run(const Job& j, std::vector<uint8_t>& scratch) {
    int* sh = j.dims ? j.dims : nullptr;
    int* sw = j.dims ? j.dims + 1 : nullptr;
    if (j.resize_to == 0 || j.resize_to == j.tile_size) {
      *j.status = decode_jpeg_into(j.path, j.out, j.tile_size, j.tile_size,
                                   1, 1, sh, sw);
      return;
    }
    // DCT-domain scaled decode: when the gather target is at most
    // tile/denom, decode directly at 1/denom — libjpeg runs a
    // (8/denom)-point IDCT, cutting IDCT + color-conversion work ~denom²×.
    // The downstream gather uses floor(i * decoded/dst) indices, so the
    // result is the nearest-resize of the SCALED image (a low-passed
    // rendition of the full-size one), not bit-identical to the full-decode
    // path — callers opt in (fast_decode) and own the parity story.
    const int denom = (j.scale_denom > 1 &&
                       j.tile_size % j.scale_denom == 0 &&
                       j.tile_size / j.scale_denom >= j.resize_to)
                          ? j.scale_denom : 1;
    const int dec = j.tile_size / denom;
    scratch.resize(static_cast<size_t>(dec) * dec * 3);
    *j.status = decode_jpeg_into(j.path, scratch.data(), dec, dec,
                                 1, denom, sh, sw);
    if (*j.status == 0) {
      nearest_resize(scratch.data(), dec, dec, j.out, j.resize_to);
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::queue<Job> jobs_;
  std::vector<std::thread> threads_;
  int outstanding_ = 0;
  bool stop_;
};

}  // namespace

extern "C" {

void* tile_pool_create(int n_threads) { return new Pool(n_threads); }

void tile_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode a batch of JPEG paths into a contiguous NHWC uint8 buffer.
// out must hold n * side * side * 3 bytes where side = resize_to ? resize_to
// : tile_size.  statuses must hold n ints (0 = ok).  dims, when non-null,
// must hold 2n ints and receives each source's decoded (h, w) — callers use
// it to spot WSI border tiles that need the centered-pad geometry.
void tile_pool_decode_batch(void* pool, const char** paths, int n,
                            uint8_t* out, int tile_size, int resize_to,
                            int scale_denom, int* statuses, int* dims) {
  Pool* p = static_cast<Pool*>(pool);
  const int side = resize_to ? resize_to : tile_size;
  const size_t stride = static_cast<size_t>(side) * side * 3;
  for (int i = 0; i < n; ++i) {
    p->submit(Job{paths[i], out + stride * i, tile_size, resize_to,
                  scale_denom, statuses + i, dims ? dims + 2 * i : nullptr});
  }
  p->wait_all();
}

// Single-image convenience (used by tests and the CAA-filter crop path).
int tile_decode_one(const char* path, uint8_t* out, int out_h, int out_w) {
  return decode_jpeg_into(path, out, out_h, out_w, 1, 1);
}

// Serving fast path (serving.py:_detect_one): decode an in-memory JPEG
// that must be EXACTLY (tile_size, tile_size) — other geometries return 3
// after the header only (cheap), and the caller takes the general
// pad_to_square path.  resize_to > 0 applies the nearest gather
// (floor(i*src/dst), parity with ops.preprocess.nearest_indices);
// scale_denom > 1 opts into the DCT-domain scaled decode (fast_decode
// semantics — see Pool::run above; NOT bit-identical to full decode).
// out must hold side*side*3 bytes where side = resize_to ? resize_to
// : tile_size.  Returns 0 ok / 2 corrupt / 3 wrong geometry.
int tile_decode_mem(const uint8_t* jpeg, unsigned long len, uint8_t* out,
                    int tile_size, int resize_to, int scale_denom,
                    int* src_h, int* src_w) {
  if (resize_to == 0 || resize_to == tile_size) {
    return decode_jpeg_mem_into(jpeg, len, out, tile_size, tile_size, 1, 1,
                                src_h, src_w, tile_size, tile_size);
  }
  const int denom = (scale_denom > 1 && tile_size % scale_denom == 0 &&
                     tile_size / scale_denom >= resize_to)
                        ? scale_denom : 1;
  const int dec = tile_size / denom;
  std::vector<uint8_t> scratch(static_cast<size_t>(dec) * dec * 3);
  int rc = decode_jpeg_mem_into(jpeg, len, scratch.data(), dec, dec, 1, denom,
                                src_h, src_w, tile_size, tile_size);
  if (rc == 0) nearest_resize(scratch.data(), dec, dec, out, resize_to);
  return rc;
}

}  // extern "C"
